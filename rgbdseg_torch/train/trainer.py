"""The train step, evaluation and prediction (counterparts of the train step
of `rgbdseg_tpu/train/trainer.py`: `_loss_grads`, `_train_step_fn`,
`_accum_step_fn`, `_apply_step_fn`, `_put`, `_cast_bf16`, and of
`Trainer.evaluate`, `Trainer.predict` and `save_metrics`).

- `put_batch` ships a host `data.pipeline.Batch` to the device as the JAX
  `_put` does on one process: the targets compacted to their power-of-two
  bucket under `compact_instances`, the bit-packed masks shipped under
  `pack_targets`, raw uint8 frames as they are.
- `micro_step` runs the forward in train mode (drop path, dropout, BatchNorm on
  batch statistics and its running-stat update), the Mask2Former criterion
  over every prediction layer and the backward (through the K1 and K3
  backward kernels on the card), and adds the gradients to each parameter's
  float32 `.grad`. Raw uint8 frames are built into the channel stack on the
  device (`device_preprocess.build_from_packed`) and bit-packed masks unpacked
  there, inside the step.
- `apply_step` divides the summed gradients by the number of micro-batches
  actually accumulated, clips and runs AdamW; `train_step` is one micro-step
  and its apply.
- Under `TrainingArguments.bf16` the forward runs on a bfloat16 copy of every
  float32 parameter and of the pixel stack (`torch.func.functional_call`), the
  outputs are cast to float32 before the loss, and the gradients flow back
  through the cast to the float32 master parameters; the optimizer state and
  the BatchNorm running statistics stay float32. The modules promote mixed
  operands as flax does (`models/layers.py`). `evaluate` and `predict` take
  the same policy.

The model runs on the device of its parameters; the batch is moved there. One
`torch.Generator` drives the dropout and drop-path masks and the criterion's
point coordinates. `build_training` applies `matmul_precision` as the JAX
Trainer does at init: float32 / bfloat16_3x / bfloat16 select torch's
"highest" / "high" / "medium" float32 matmul precision, with cuDNN's TF32
switch set to match. K3 and its backward compute 3xTF32 products whatever the
setting (`csrc/mma_tf32.cuh`).

Not ported yet (ROADMAP.md §1 item 3): the dataset, the epoch loop,
checkpoints and the finetune CLI.
"""

from __future__ import annotations

import json
import math
import os
import time
from typing import Iterable, NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..config import ModelConfig, PreprocessConfig
from ..data.device_preprocess import build_from_packed, unpack_masks
from ..data.pipeline import Batch, compact_targets
from ..inference.predictor import resolve_device
from ..models.mask2former import Mask2FormerRGBD, ModelOutputs
from ..ops.losses import mask2former_loss
from ..utils.weights import init_weights
from ..versions import get as get_version
from .arguments import TrainingArguments, check_supported
from .evaluator import Evaluator
from .optim import AdamW

# TrainingArguments.matmul_precision -> torch's float32 matmul precision
MATMUL_PRECISION = {"float32": "highest", "bfloat16_3x": "high", "bfloat16": "medium"}


class TrainBatch(NamedTuple):
    # (B, H, W, C) float32 channel stack, or (B, H', W', packed_width) raw uint8 frames
    pixel_values: torch.Tensor
    # (B, T, H, W) float32 0/1, or (B, T, ceil(H*W/8)) uint8 bit-packed, padded to T instances
    mask_labels: torch.Tensor
    class_labels: torch.Tensor  # (B, T) int
    valid: torch.Tensor  # (B, T) bool: which of the T slots are real instances


def set_matmul_precision(precision: str) -> None:
    """float32 | bfloat16_3x | bfloat16 -> torch's float32 matmul precision, and
    cuDNN's TF32 switch on for all but float32."""
    if precision not in MATMUL_PRECISION:
        raise ValueError(f"matmul_precision {precision!r} is not one of {sorted(MATMUL_PRECISION)}")
    torch.set_float32_matmul_precision(MATMUL_PRECISION[precision])
    torch.backends.cudnn.allow_tf32 = precision != "float32"


def make_optimizer(model: torch.nn.Module, args: TrainingArguments, num_examples: int) -> AdamW:
    """AdamW over all parameters, with the JAX trainer's step count: an epoch is
    ceil(ceil(examples / batch) / gradient_accumulation_steps) optimizer steps,
    for num_train_epochs epochs."""
    micro = max(1, math.ceil(num_examples / args.per_device_train_batch_size))
    steps_per_epoch = max(1, math.ceil(micro / max(1, args.gradient_accumulation_steps)))
    total = max(1, int(steps_per_epoch * args.num_train_epochs))
    return AdamW(model.named_parameters(), args, total)


def build_training(cfg: ModelConfig, args: TrainingArguments, num_examples: int, device=None, seed: int = 0):
    """(model, optimizer): the model with the port's seeded weights on the CUDA
    device unless `device` names another (raises without CUDA), in train mode.
    Applies `args.matmul_precision`; raises NotImplementedError for arguments
    the port does not honour yet (`arguments.check_supported`)."""
    check_supported(args)
    dev = resolve_device(device)
    set_matmul_precision(args.matmul_precision)
    model = init_weights(Mask2FormerRGBD(cfg), seed).to(dev).train()
    return model, make_optimizer(model, args, num_examples)


def put_batch(batch: Batch, args: TrainingArguments, device=None) -> TrainBatch:
    """Host batch -> tensors on `device` (the CUDA device unless it names
    another; raises without CUDA), as the JAX `_put` does on one process:
    targets compacted under `compact_instances`, the bit-packed masks shipped
    in place of the float ones under `pack_targets` when the batch carries them."""
    device = resolve_device(device)
    mk, cl, vd = batch.mask_labels, batch.class_labels, batch.valid
    packed = batch.mask_labels_packed if args.pack_targets else None
    if args.compact_instances:
        if packed is not None:
            mk, cl, vd, packed = compact_targets(mk, cl, vd, args.instance_bucket_floor, packed=packed)
        else:
            mk, cl, vd = compact_targets(mk, cl, vd, args.instance_bucket_floor)
    if packed is not None:
        mk = packed
    return TrainBatch(*(torch.from_numpy(np.ascontiguousarray(x)).to(device)
                        for x in (batch.pixel_values, mk, cl, np.asarray(vd, bool))))


def _inputs(model, batch: TrainBatch, preprocess: Optional[PreprocessConfig]):
    """(pixel stack, float masks, classes, valid) on the model's device: raw
    uint8 frames built into the stack, bit-packed masks unpacked at its size."""
    dev = next(model.parameters()).device
    pix = batch.pixel_values.to(dev)
    if pix.dtype == torch.uint8:
        pix = build_from_packed(get_version(model.cfg.version).map_fn, pix, preprocess or PreprocessConfig())
    masks = batch.mask_labels.to(dev)
    if masks.dtype == torch.uint8:
        masks = unpack_masks(masks, tuple(pix.shape[1:3]))
    return pix, masks, batch.class_labels.to(dev), batch.valid.to(dev)


def forward(model, pixel_values: torch.Tensor, generator: Optional[torch.Generator] = None,
            bf16: bool = False) -> ModelOutputs:
    """The model's forward; with `bf16`, on a bfloat16 copy of its float32
    parameters and of the pixels (differentiable casts, so gradients reach the
    float32 masters), the outputs cast to float32."""
    if not bf16:
        return model(pixel_values, generator)
    params = {n: p.to(torch.bfloat16) if p.dtype == torch.float32 else p for n, p in model.named_parameters()}
    out = torch.func.functional_call(model, params, (pixel_values.to(torch.bfloat16), generator))
    return ModelOutputs(out.class_queries_logits.float(), out.masks_queries_logits.float(),
                        tuple(t.float() for t in out.aux_class_logits), tuple(t.float() for t in out.aux_mask_logits))


def micro_step(model, optimizer: AdamW, batch: TrainBatch, generator: torch.Generator,
               preprocess: Optional[PreprocessConfig] = None):
    """Forward, loss and backward of one micro-batch; its gradients are added to
    each parameter's float32 `.grad`. Returns (loss, per-layer losses) as device
    tensors."""
    model.train()
    pix, masks, classes, valid = _inputs(model, batch, preprocess)
    outputs = forward(model, pix, generator, optimizer.args.bf16)
    loss, per_layer = mask2former_loss(model.cfg, outputs, masks, classes, valid, generator)
    loss.backward()
    return loss.detach(), {k: v.detach() for k, v in per_layer.items()}


def apply_step(optimizer: AdamW, count: int) -> torch.Tensor:
    """One optimizer step on the gradients summed over `count` micro-batches:
    their exact mean (an epoch's remainder divides by its own count), then clip
    and AdamW; the gradients are cleared. Returns the mean gradient's global
    norm before clipping."""
    if count > 1:
        grads = [p.grad for g in optimizer.param_groups for p in g["params"] if p.grad is not None]
        torch._foreach_div_(grads, float(count))
    grad_norm = optimizer.step()
    optimizer.zero_grad(set_to_none=True)
    return grad_norm


def train_step(model, optimizer: AdamW, batch: TrainBatch, generator: torch.Generator,
               preprocess: Optional[PreprocessConfig] = None):
    """Forward, loss, backward, clip and update on one batch. Returns (loss,
    per-layer losses, gradient norm before clipping) as device tensors."""
    optimizer.zero_grad(set_to_none=True)
    loss, per_layer = micro_step(model, optimizer, batch, generator, preprocess)
    return loss, per_layer, apply_step(optimizer, 1)


def _eval_outputs(model, batches: Iterable[Batch], preprocess, generator, bf16):
    """Per batch: (batch, the eval-mode outputs, the eval loss) on the model's device."""
    dev = next(model.parameters()).device
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    was_training = model.training
    model.eval()
    try:
        for batch in batches:
            arrays = (batch.pixel_values, batch.mask_labels_packed if batch.mask_labels_packed is not None
                      else np.asarray(batch.mask_labels, np.float32), batch.class_labels, np.asarray(batch.valid, bool))
            pix, masks, classes, valid = _inputs(
                model, TrainBatch(*(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)), preprocess)
            out = forward(model, pix, bf16=bf16)
            loss, _ = mask2former_loss(model.cfg, out, masks, classes, valid, generator)
            yield batch, out, loss
    finally:
        model.train(was_training)


@torch.no_grad()
def evaluate(
    model,
    batches: Iterable[Batch],
    id2label: dict[int, str],
    preprocess: Optional[PreprocessConfig] = None,
    prefix: str = "eval_",
    generator: Optional[torch.Generator] = None,
    bf16: bool = False,
) -> dict:
    """Eval loss and mask mAP of `model` over `batches`, on the model's device.

    Each `data.pipeline.Batch` is uploaded as it is: float channel stacks, or
    raw uint8 frames (B, H, W, packed_width) built into the stack on the device
    (`device_preprocess.build_from_packed` with `preprocess`); the masks plain,
    or bit-packed in `mask_labels_packed` and unpacked there. The model runs in
    eval mode (with `bf16`, under the bf16 policy of `forward`); the loss is
    `mask2former_loss` with its points from `generator` (default: seeded 0 on
    the model's device); the logits stay on the device for `Evaluator.update`.
    Returns {prefix}loss (the mean over batches), the mAP keys,
    {prefix}runtime (s) and {prefix}samples_per_second."""
    evaluator = Evaluator(id2label, threshold=0.0)
    losses, n = [], 0
    t0 = time.perf_counter()
    for batch, out, loss in _eval_outputs(model, batches, preprocess, generator, bf16):
        losses.append(loss)
        evaluator.update(out.class_queries_logits, out.masks_queries_logits, batch)
        n += out.class_queries_logits.shape[0]
    evaluator.flush()
    losses = torch.stack(losses).cpu().tolist()
    runtime = time.perf_counter() - t0
    metrics = {prefix + "loss": float(np.mean(losses))}
    metrics.update(evaluator.compute(prefix=prefix))
    metrics[prefix + "runtime"] = round(runtime, 4)
    metrics[prefix + "samples_per_second"] = round(n / max(runtime, 1e-9), 3)
    return metrics


@torch.no_grad()
def predict(
    model,
    batches: Sequence[Batch],
    id2label: dict[int, str],
    preprocess: Optional[PreprocessConfig] = None,
    prefix: str = "test_",
    num_examples: Optional[int] = None,
    bf16: bool = False,
) -> tuple[list, dict]:
    """(the host logits (class (b, Q, L+1), mask (b, Q, h, w)) of each batch
    cut to its real rows, `evaluate`'s metrics over the same batches). The last
    batch's rows past `num_examples` (a chunk padded by repetition) are cut."""
    outputs, seen = [], 0
    for batch, out, _ in _eval_outputs(model, batches, preprocess, None, bf16):
        b = out.class_queries_logits.shape[0]
        real = b if num_examples is None else max(0, min(b, num_examples - seen))
        outputs.append((out.class_queries_logits[:real].cpu().numpy(), out.masks_queries_logits[:real].cpu().numpy()))
        seen += b
    return outputs, evaluate(model, batches, id2label, preprocess, prefix=prefix, bf16=bf16)


def save_metrics(output_dir: str, split: str, metrics: dict) -> None:
    """HF-compatible metrics JSON files ({split}_results.json and all_results.json)."""
    os.makedirs(output_dir, exist_ok=True)
    with open(os.path.join(output_dir, f"{split}_results.json"), "w") as f:
        json.dump(metrics, f, indent=2, sort_keys=True)
    all_path = os.path.join(output_dir, "all_results.json")
    allm = {}
    if os.path.exists(all_path):
        with open(all_path) as f:
            allm = json.load(f)
    allm.update(metrics)
    with open(all_path, "w") as f:
        json.dump(allm, f, indent=2, sort_keys=True)
