"""The FLOPs of one step or eval batch, counted on the benchmark's own
reference at the cell's shapes, so that the count reads the same work
whatever implements it: torch's `FlopCounterMode` over the reference's
forward, criterion and (for a step) backward of one image of the cell,
times the batch. Every operation the reference runs is an aten operation the
mode sees, the deformable sampling's corner products and the attention's
included, except the point sampling (`F.grid_sample`), whose 8 operations per
point are added by hand. The optimizer's elementwise work is not counted.
"""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

from .check import _targets, reference_model
from .reference import criterion, evaluation, ops
from .reference.model import channel_stack


def _one(batch: dict) -> dict:
    return {k: v[:1] for k, v in batch.items()}


def _count(cfg, state, batch, traffic, device, train: bool) -> float:
    model = reference_model(cfg, state, device, train).requires_grad_(train)
    b = _one(batch)
    gen = torch.Generator(device=device).manual_seed(0)
    points = {"n": 0}
    sample = ops.point_sample

    def counted(masks, coords):
        points["n"] += coords.numel() // 2
        return sample(masks, coords)

    ops.point_sample = counted
    try:
        with FlopCounterMode(display=False) as counter, torch.set_grad_enabled(train):
            pix = channel_stack(cfg.version, torch.from_numpy(b["frames"]).to(device))
            classes, masks = model(pix, gen)
            targets = _targets(b, device, traffic["bucket_floor"] if train else None)
            loss = criterion.mask2former_loss(cfg, classes, masks, *targets, gen)
            if train:
                loss.backward()
            else:
                evaluation.eval_stats(classes[-1], masks[-1], targets[0], targets[2])
        total = counter.get_total_flops() + 8 * points["n"] * (2 if train else 1)
    finally:
        ops.point_sample = sample
    del model
    return float(total) * traffic["batch"]


def train_step(cfg, state, batch, traffic, device) -> float:
    """FLOPs of one optimizer step of the cell's batch."""
    return _count(cfg, state, batch, traffic, device, True)


def eval_batch(cfg, state, batch, traffic, device) -> float:
    """FLOPs of one eval batch: forward, eval loss and the mAP's statistics."""
    return _count(cfg, state, batch, traffic, device, False)
