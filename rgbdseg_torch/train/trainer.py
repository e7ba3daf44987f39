"""One optimizer step of the model (counterpart of the fused train step of
`rgbdseg_tpu/train/trainer.py`, `_loss_grads` and `_train_step_fn`).

`train_step` runs the forward in train mode (drop path, dropout, BatchNorm on
batch statistics and its running-stat update), the Mask2Former criterion over
every prediction layer, the backward (through the K1 and K3 backward kernels on
the card), global-norm clipping and AdamW. The model runs on the device of its
parameters; the batch must be there too. One `torch.Generator` drives the
dropout and drop-path masks and the criterion's point coordinates.

Not ported yet (ROADMAP.md): gradient accumulation, bf16 training, target
compaction and packed targets, checkpoints, the dataset and the finetune CLI.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..config import ModelConfig
from ..inference.predictor import resolve_device
from ..models.mask2former import Mask2FormerRGBD
from ..ops.losses import mask2former_loss
from ..utils.weights import init_weights
from .arguments import TrainingArguments
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
