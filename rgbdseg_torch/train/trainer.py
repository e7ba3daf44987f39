"""One optimizer step of the model, and evaluation (counterparts of the fused
train step of `rgbdseg_tpu/train/trainer.py`, `_loss_grads` and
`_train_step_fn`, and of `Trainer.evaluate` with `_eval_step_fn`).

`train_step` runs the forward in train mode (drop path, dropout, BatchNorm on
batch statistics and its running-stat update), the Mask2Former criterion over
every prediction layer, the backward (through the K1 and K3 backward kernels on
the card), global-norm clipping and AdamW. The model runs on the device of its
parameters; the batch must be there too. One `torch.Generator` drives the
dropout and drop-path masks and the criterion's point coordinates.

`evaluate` runs the model in eval mode over batches of float channel stacks or
raw uint8 frames (the stack then built on the model's device), with the eval
loss and the mask mAP of `train/evaluator.py`.

Not ported yet (ROADMAP.md): gradient accumulation, bf16 training, target
compaction and packed targets, checkpoints, the dataset and the finetune CLI.
"""

from __future__ import annotations

import math
import time
from typing import Iterable, NamedTuple, Optional

import numpy as np
import torch

from ..config import ModelConfig, PreprocessConfig
from ..data.device_preprocess import build_from_packed, unpack_masks
from ..data.pipeline import Batch
from ..inference.predictor import resolve_device
from ..models.mask2former import Mask2FormerRGBD
from ..ops.losses import mask2former_loss
from ..utils.weights import init_weights
from ..versions import get as get_version
from .arguments import TrainingArguments
from .evaluator import Evaluator
from .optim import AdamW


class TrainBatch(NamedTuple):
    pixel_values: torch.Tensor  # (B, H, W, C) float32, the version's channel stack
    mask_labels: torch.Tensor  # (B, T, H, W) float32 0/1, padded to T instances
    class_labels: torch.Tensor  # (B, T) int
    valid: torch.Tensor  # (B, T) bool: which of the T slots are real instances


def make_optimizer(model: torch.nn.Module, args: TrainingArguments, num_examples: int) -> AdamW:
    """AdamW over all parameters, with the JAX trainer's step count: one epoch is
    ceil(examples / batch) steps, for num_train_epochs epochs."""
    steps_per_epoch = max(1, math.ceil(num_examples / args.per_device_train_batch_size))
    total = max(1, int(steps_per_epoch * args.num_train_epochs))
    return AdamW(model.named_parameters(), args, total)


def build_training(cfg: ModelConfig, args: TrainingArguments, num_examples: int, device=None, seed: int = 0):
    """(model, optimizer): the model with the port's seeded weights on the CUDA
    device unless `device` names another (raises without CUDA), in train mode."""
    model = init_weights(Mask2FormerRGBD(cfg), seed).to(resolve_device(device)).train()
    return model, make_optimizer(model, args, num_examples)


def train_step(model, optimizer: AdamW, batch: TrainBatch, generator: torch.Generator):
    """Forward, loss, backward, clip and update. Returns (loss, per-layer losses,
    gradient norm before clipping) as device tensors."""
    model.train()
    outputs = model(batch.pixel_values, generator)
    loss, per_layer = mask2former_loss(model.cfg, outputs, batch.mask_labels, batch.class_labels, batch.valid,
                                       generator)
    optimizer.zero_grad(set_to_none=True)
    loss.backward()
    grad_norm = optimizer.step()
    return loss.detach(), {k: v.detach() for k, v in per_layer.items()}, grad_norm


@torch.no_grad()
def evaluate(
    model,
    batches: Iterable[Batch],
    id2label: dict[int, str],
    preprocess: Optional[PreprocessConfig] = None,
    prefix: str = "eval_",
    generator: Optional[torch.Generator] = None,
) -> dict:
    """Eval loss and mask mAP of `model` over `batches`, on the model's device.

    Each `data.pipeline.Batch` is uploaded as it is: float channel stacks, or
    raw uint8 frames (B, H, W, packed_width) built into the stack on the device
    (`device_preprocess.build_from_packed` with `preprocess`); the masks plain,
    or bit-packed in `mask_labels_packed` and unpacked there. The model runs in
    eval mode; the loss is `mask2former_loss` with its points from `generator`
    (default: seeded 0 on the model's device); the logits stay on the device
    for `Evaluator.update`. Returns {prefix}loss (the mean over batches), the
    mAP keys, {prefix}runtime (s) and {prefix}samples_per_second."""
    dev = next(model.parameters()).device
    pp = preprocess or PreprocessConfig()
    map_fn = get_version(model.cfg.version).map_fn
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    evaluator = Evaluator(id2label, threshold=0.0)
    was_training = model.training
    model.eval()
    losses, n = [], 0
    t0 = time.perf_counter()
    for batch in batches:
        pix = torch.from_numpy(np.ascontiguousarray(batch.pixel_values)).to(dev)
        if pix.dtype == torch.uint8:
            pix = build_from_packed(map_fn, pix, pp)
        if batch.mask_labels_packed is not None:
            masks = unpack_masks(torch.from_numpy(batch.mask_labels_packed).to(dev), batch.mask_labels.shape[2:])
        else:
            masks = torch.from_numpy(np.ascontiguousarray(batch.mask_labels, np.float32)).to(dev)
        classes = torch.from_numpy(np.asarray(batch.class_labels)).to(dev)
        valid = torch.from_numpy(np.asarray(batch.valid, bool)).to(dev)
        out = model(pix)
        loss, _ = mask2former_loss(model.cfg, out, masks, classes, valid, generator)
        losses.append(loss)
        evaluator.update(out.class_queries_logits, out.masks_queries_logits, batch)
        n += pix.shape[0]
    evaluator.flush()
    losses = torch.stack(losses).cpu().tolist()
    runtime = time.perf_counter() - t0
    model.train(was_training)
    metrics = {prefix + "loss": float(np.mean(losses))}
    metrics.update(evaluator.compute(prefix=prefix))
    metrics[prefix + "runtime"] = round(runtime, 4)
    metrics[prefix + "samples_per_second"] = round(n / max(runtime, 1e-9), 3)
    return metrics
