"""The train step's optimizer: optax's `chain(clip_by_global_norm, adamw)` with
HF's weight-decay set and the linear warmup-and-decay schedule, written out in
torch (counterpart of `rgbdseg_tpu/train/trainer.py::_hf_decay_mask` and of the
optax chain that `Trainer._init_state` builds).

It follows optax operation by operation, not `torch.optim.AdamW` or
`clip_grad_norm_`, which round differently:
- clipping multiplies by `max_norm / norm` as `(g / norm) * max_norm`, and only
  when `norm >= max_norm` (no `+ 1e-6`);
- Adam: mu = (1 - b1) g + b1 mu, nu = (1 - b2) g² + b2 nu, bias-corrected by
  1 - b^t, update mu_hat / (sqrt(nu_hat) + eps) (eps outside the root);
- decoupled decay adds wd * p to the update of the decayed parameters, then
  the update is scaled by -lr(t) with t counted from 0 at the first step.
A parameter without a gradient gets a zero one first: optax still moves its
moments and decays it, where torch's AdamW would skip it. The E-DSAM ratio
predictor is such a parameter set (its output only sets depth-window
thresholds, so no gradient reaches it), and so is the 0.4.0 backbone (both
fusion branches read detached copies of its maps). The one exception is the
reference-frozen set (`FROZEN_MODULES`): the 0.0.7 intrinsics predictor feeds
only the detached surface normals, so the reference's torch AdamW, seeing its
gradients None, skips it (no step, no decay), and the JAX trainer masks its
updates to zero. Its parameters are left out of the optimizer here; no other
version has them, so their optimizer state and checkpoints are unchanged.

Each operation runs over all parameters at once (torch's multi-tensor
`_foreach_*` ops, which round each element as the single-tensor op does): a
loop of single-tensor ops over the 656 parameter tensors of the full-width
model made some 7,000 launches per step and held the step on the host. Clipping needs no host sync: the gradients are divided by
where(norm < max, 1, norm) and multiplied by where(norm < max, 1, max).

`state_dict` / `load_state_dict` carry optax's step count and the moments
keyed by parameter name (torch's own key them by position across the decay
groups), for the checkpoints of `train/checkpoints.py`.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..models.mask2former import INTRINSICS_PREDICTOR
from .arguments import TrainingArguments

# Modules whose parameters no optimizer step touches (see above).
FROZEN_MODULES = (INTRINSICS_PREDICTOR,)


def is_frozen(name: str) -> bool:
    return any(part in FROZEN_MODULES for part in name.split("."))


def is_decayed(name: str) -> bool:
    """HF Trainer's decay set on the port's (flax-named) parameter names: no decay
    for any name part containing "bias" (which also catches Swin's
    relative_position_bias_table) or for LayerNorm modules, which are the modules
    with "norm" in their name except the GroupNorms (input_proj*, adapter*,
    fpn*) and the BatchNorms (*bn*), whose scales do decay."""
    parts = name.split(".")
    if any("bias" in p for p in parts):
        return False
    parent = parts[-2] if len(parts) > 1 else ""
    return not ("norm" in parent and "bn" not in parent and not parent.startswith(("input_proj", "adapter", "fpn")))


def linear_schedule(learning_rate: float, total_steps: int, warmup_ratio: float):
    """optax.join_schedules of a linear warmup over ceil(warmup_ratio * total)
    steps and a linear decay to 0, in float32 as optax computes it."""
    warmup = math.ceil(warmup_ratio * total_steps)

    def linear(init: float, end: float, steps: int, count: int) -> np.float32:
        c = np.float32(min(max(count, 0), steps))
        frac = np.float32(1) - c / np.float32(steps)
        return np.float32(init - end) * frac + np.float32(end)

    def schedule(count: int) -> float:
        if warmup > 0 and count < max(warmup, 1):
            return float(linear(0.0, learning_rate, max(warmup, 1), count))
        boundary = max(warmup, 1) if warmup > 0 else 0
        return float(linear(learning_rate, 0.0, max(total_steps - warmup, 1), count - boundary))

    return schedule


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every element, as the norm of the tensors' norms."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm([t.float() for t in tensors])))


class AdamW(torch.optim.Optimizer):
    """clip_by_global_norm(max_grad_norm) then AdamW, as the JAX trainer's optax
    chain over every parameter outside `FROZEN_MODULES`. `step()` returns the
    global norm of the gradients before clipping."""

    def __init__(self, named_parameters, args: TrainingArguments, total_steps: int):
        named = [(n, p) for n, p in named_parameters if not is_frozen(n)]
        groups = [
            {"params": [p for n, p in named if is_decayed(n)], "weight_decay": args.weight_decay},
            {"params": [p for n, p in named if not is_decayed(n)], "weight_decay": 0.0},
        ]
        super().__init__([g for g in groups if g["params"]], {"weight_decay": 0.0})
        self.args = args
        self.names = {p: n for n, p in named}
        self.total_steps = total_steps
        self.schedule = linear_schedule(args.learning_rate, total_steps, args.warmup_ratio)
        self.count = 0  # optimizer steps taken (optax's count)

    def state_dict(self) -> dict:
        """{"count": steps taken, "state": {parameter name: {"mu", "nu"}}} on the
        CPU: the moments keyed by the parameter they belong to, not by position."""
        return {"count": self.count,
                "state": {self.names[p]: {k: v.detach().cpu().clone() for k, v in st.items()}
                          for p, st in self.state.items() if st}}

    def load_state_dict(self, state_dict: dict) -> None:
        """Restore `state_dict()`'s count and moments onto the parameters of the
        same names, on their devices; every parameter's moments, or none, must be
        there."""
        saved = state_dict["state"]
        params = [p for g in self.param_groups for p in g["params"]]
        names = {self.names[p] for p in params}
        if saved and set(saved) != names:
            raise ValueError(f"optimizer state for {len(saved)} parameters does not match the model's "
                             f"{len(names)}: missing {sorted(names - set(saved))[:5]}, "
                             f"unknown {sorted(set(saved) - names)[:5]}")
        self.state.clear()
        for p in params:
            st = saved.get(self.names[p])
            if st is not None:
                self.state[p].update({k: v.to(device=p.device, dtype=p.dtype).clone() for k, v in st.items()})
        self.count = int(state_dict["count"])

    @torch.no_grad()
    def step(self, closure=None) -> torch.Tensor:
        if closure is not None:
            raise ValueError("this optimizer takes no closure")
        a = self.args
        params = [p for g in self.param_groups for p in g["params"]]
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        norm = global_norm([p.grad for p in params])
        keep = norm < a.max_grad_norm  # on the device: no host sync
        div = torch.where(keep, 1.0, norm)
        mul = torch.where(keep, 1.0, torch.full_like(norm, a.max_grad_norm))
        neg_lr = float(-np.float32(self.schedule(self.count)))
        t = self.count + 1
        bc1 = float(np.float32(1) - np.float32(a.adam_beta1) ** np.float32(t))
        bc2 = float(np.float32(1) - np.float32(a.adam_beta2) ** np.float32(t))
        for group in self.param_groups:
            ps = group["params"]
            for p in ps:
                if not self.state[p]:
                    self.state[p].update(mu=torch.zeros_like(p), nu=torch.zeros_like(p))
            g = torch._foreach_mul(torch._foreach_div([p.grad for p in ps], div), mul)
            mu = torch._foreach_add(torch._foreach_mul(g, 1 - a.adam_beta1),
                                    torch._foreach_mul([self.state[p]["mu"] for p in ps], a.adam_beta1))
            nu = torch._foreach_add(torch._foreach_mul(torch._foreach_mul(g, g), 1 - a.adam_beta2),
                                    torch._foreach_mul([self.state[p]["nu"] for p in ps], a.adam_beta2))
            for p, m, n in zip(ps, mu, nu):
                self.state[p]["mu"], self.state[p]["nu"] = m, n
            denom = torch._foreach_add(torch._foreach_sqrt(torch._foreach_div(nu, bc2)), a.adam_epsilon)
            update = torch._foreach_div(torch._foreach_div(mu, bc1), denom)
            if group["weight_decay"]:
                update = torch._foreach_add(update, torch._foreach_mul(ps, group["weight_decay"]))
            torch._foreach_add_(ps, torch._foreach_mul(update, neg_lr))
        self.count = t
        return norm
