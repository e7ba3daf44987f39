"""The benchmark's seeded weights: the rules of the port's `utils/weights.py::
init_weights`, drawn on the device in one call.

Linear and convolution weights are normal with std 1 / sqrt(fan_in) and their
biases zero; norms have unit scales and zero biases; every deformable
attention starts at the direction grid of its sampling-offset bias with a zero
offset kernel and zero attention weights (uniform attention); the level
embeddings and the queries are normal(1); Swin's relative-position tables are
zero; BatchNorm's running statistics start at (0, 1). The leaves are read off
the reference model's modules, by the names the port shares with it.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from .reference.model import DeformableAttention, offset_bias_grid

_UNIT_NORMAL = ("level_embed", "queries_embedder", "queries_features")


def _plan(model: nn.Module) -> dict:
    """name -> ("normal", std) | ("const", value) | ("grid", (nh, nl, npts))."""
    plan = {name: ("const", 0.0) for name, _ in model.named_parameters()}
    for mname, module in model.named_modules():
        prefix = f"{mname}." if mname else ""
        if isinstance(module, (nn.Linear, nn.Conv2d)):
            plan[prefix + "weight"] = ("normal", 1.0 / math.sqrt(module.weight[0].numel()))
        elif isinstance(module, (nn.LayerNorm, nn.GroupNorm, nn.BatchNorm2d)):
            plan[prefix + "weight"] = ("const", 1.0)
    for mname, module in model.named_modules():
        if isinstance(module, DeformableAttention):
            plan[f"{mname}.sampling_offsets.weight"] = ("const", 0.0)
            plan[f"{mname}.sampling_offsets.bias"] = ("grid", (module.nh, module.nl, module.npts))
            plan[f"{mname}.attention_weights.weight"] = ("const", 0.0)
    for name in plan:
        if name.rpartition(".")[2] in _UNIT_NORMAL:
            plan[name] = ("normal", 1.0)
    return plan


@torch.no_grad()
def init_state(model: nn.Module, seed: int, device) -> dict[str, torch.Tensor]:
    """The state dict (parameters and persistent buffers) of `model` (the
    reference, on any device, `meta` too) drawn from `seed` on `device`."""
    plan = _plan(model)
    shapes = {n: p.shape for n, p in model.named_parameters()}
    normal = [n for n, (kind, _) in plan.items() if kind == "normal"]
    gen = torch.Generator(device=device).manual_seed(int(seed))
    draw = torch.randn(sum(shapes[n].numel() for n in normal), generator=gen, device=device)
    parts = draw.split([shapes[n].numel() for n in normal])
    state = {}
    for n, part in zip(normal, torch._foreach_mul(list(parts), [plan[n][1] for n in normal])):
        state[n] = part.view(shapes[n])
    for n, (kind, arg) in plan.items():
        if kind == "const":
            state[n] = torch.full(shapes[n], arg, dtype=torch.float32, device=device)
        elif kind == "grid":
            state[n] = torch.from_numpy(offset_bias_grid(*arg)).to(device)
    for n, buf in model.state_dict().items():
        if n in state:
            continue
        leaf = n.rpartition(".")[2]
        value = {"running_mean": 0.0, "running_var": 1.0, "num_batches_tracked": 0}[leaf]
        state[n] = torch.full(buf.shape, value, dtype=buf.dtype, device=device)
    return state
