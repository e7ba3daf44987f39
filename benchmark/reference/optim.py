"""The reference optimizer: optax's chain(clip_by_global_norm, adamw) under a
linear warmup-and-decay schedule, with HF's weight-decay set, operation by
operation as the port's `train/optim.py` (a parameter without a gradient gets
a zero one, so its moments move and it decays)."""

from __future__ import annotations

import math

import numpy as np
import torch


def is_decayed(name: str) -> bool:
    """No decay for names with a "bias" part or for LayerNorms (modules named
    *norm* other than the GroupNorms input_proj*, adapter*, fpn* and the
    BatchNorms *bn*)."""
    parts = name.split(".")
    if any("bias" in p for p in parts):
        return False
    parent = parts[-2] if len(parts) > 1 else ""
    return not ("norm" in parent and "bn" not in parent and not parent.startswith(("input_proj", "adapter", "fpn")))


def linear_schedule(learning_rate: float, total_steps: int, warmup_ratio: float):
    warmup = math.ceil(warmup_ratio * total_steps)

    def linear(init, end, steps, count):
        c = np.float32(min(max(count, 0), steps))
        return np.float32(init - end) * (np.float32(1) - c / np.float32(steps)) + np.float32(end)

    def schedule(count: int) -> float:
        if warmup > 0 and count < max(warmup, 1):
            return float(linear(0.0, learning_rate, max(warmup, 1), count))
        boundary = max(warmup, 1) if warmup > 0 else 0
        return float(linear(learning_rate, 0.0, max(total_steps - warmup, 1), count - boundary))

    return schedule


class AdamW:
    """`step()` clips the gradients by their global norm and applies AdamW;
    `last_grads` keeps the clipped gradients of the last step, by name."""

    def __init__(self, named_params, lr, total_steps, warmup_ratio=0.0, weight_decay=0.0, b1=0.9, b2=0.999,
                 eps=1e-8, max_grad_norm=1.0):
        self.params = dict(named_params)
        self.schedule = linear_schedule(lr, total_steps, warmup_ratio)
        self.wd, self.b1, self.b2, self.eps, self.max_norm = weight_decay, b1, b2, eps, max_grad_norm
        self.mu = {n: torch.zeros_like(p) for n, p in self.params.items()}
        self.nu = {n: torch.zeros_like(p) for n, p in self.params.items()}
        self.count = 0
        self.last_grads = {}

    @torch.no_grad()
    def step(self) -> torch.Tensor:
        grads = {n: p.grad if p.grad is not None else torch.zeros_like(p) for n, p in self.params.items()}
        norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g.float()) for g in grads.values()]))
        keep = norm < self.max_norm
        div = torch.where(keep, 1.0, norm)
        mul = torch.where(keep, 1.0, torch.full_like(norm, self.max_norm))
        neg_lr = float(-np.float32(self.schedule(self.count)))
        t = self.count + 1
        bc1 = float(np.float32(1) - np.float32(self.b1) ** np.float32(t))
        bc2 = float(np.float32(1) - np.float32(self.b2) ** np.float32(t))
        self.last_grads = {}
        for n, p in self.params.items():
            g = grads[n] / div * mul
            self.last_grads[n] = g
            self.mu[n] = g * (1 - self.b1) + self.mu[n] * self.b1
            self.nu[n] = g * g * (1 - self.b2) + self.nu[n] * self.b2
            update = self.mu[n] / bc1 / (torch.sqrt(self.nu[n] / bc2) + self.eps)
            if self.wd and is_decayed(n):
                update = update + p * self.wd
            p.add_(update * neg_lr)
            p.grad = None
        self.count = t
        return norm
