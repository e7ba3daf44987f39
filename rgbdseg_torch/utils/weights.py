"""Weights for the port: the flax variable tree mapped onto the port's
`state_dict` and back, and the port's own seeded initialisation.

The port's module names follow the flax names (`pixel_level_module.encoder.
stage0_block0.attention.query`, ...), so the map is mechanical:
- Dense `kernel` (in, out) -> Linear `weight` (out, in); `bias` -> `bias`;
- Conv `kernel` HWIO -> Conv2d `weight` OIHW;
- LayerNorm / GroupNorm / BatchNorm `scale` -> `weight`;
- BatchNorm `batch_stats` `mean` / `var` -> `running_mean` / `running_var`
  (plus torch's `num_batches_tracked`);
- any other leaf (level embeddings, queries, relative-position tables) as is.
`to_flax` is the inverse map (without `num_batches_tracked`), so that the
port's parameters and gradients compare leaf by leaf with the JAX package's.
"""

from __future__ import annotations

import math
from typing import Mapping

import numpy as np
import torch
from torch import nn

from ..models.pixel_decoder import DeformableAttention, offset_bias_grid


def _walk(tree: Mapping, prefix: str = ""):
    for key, val in tree.items():
        path = f"{prefix}.{key}" if prefix else key
        if isinstance(val, Mapping):
            yield from _walk(val, path)
        else:
            yield path, np.asarray(val)


def from_flax(params: Mapping, batch_stats: Mapping | None = None) -> dict[str, torch.Tensor]:
    """Map the JAX package's variables (nested dicts of arrays) to a torch state_dict."""
    sd: dict[str, torch.Tensor] = {}
    for path, arr in _walk(params):
        mod, _, leaf = path.rpartition(".")
        if leaf == "kernel" and arr.ndim == 2:
            sd[f"{mod}.weight"] = torch.from_numpy(arr.T.copy())
        elif leaf == "kernel" and arr.ndim == 4:
            sd[f"{mod}.weight"] = torch.from_numpy(arr.transpose(3, 2, 0, 1).copy())
        elif leaf == "scale":
            sd[f"{mod}.weight"] = torch.from_numpy(arr.copy())
        else:
            sd[path] = torch.from_numpy(arr.copy())
    for path, arr in _walk(batch_stats or {}):
        mod, _, leaf = path.rpartition(".")
        name = {"mean": "running_mean", "var": "running_var"}[leaf]
        sd[f"{mod}.{name}"] = torch.from_numpy(arr.copy())
        sd[f"{mod}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)
    return sd


def to_flax(tensors: Mapping[str, torch.Tensor]) -> tuple[dict, dict]:
    """Inverse of `from_flax`: a state_dict, or any tensors keyed by parameter
    name (gradients, say), -> (params, batch_stats) as nested dicts of numpy arrays."""
    params: dict = {}
    stats: dict = {}

    def put(tree: dict, path: str, arr: np.ndarray) -> None:
        *mods, leaf = path.split(".")
        for m in mods:
            tree = tree.setdefault(m, {})
        tree[leaf] = arr

    for name, t in tensors.items():
        mod, _, leaf = name.rpartition(".")
        arr = t.detach().cpu().numpy()
        if leaf in ("running_mean", "running_var"):
            put(stats, f"{mod}.{leaf[len('running_'):]}", arr.copy())
        elif leaf == "num_batches_tracked":
            continue
        elif leaf == "weight" and arr.ndim == 2:
            put(params, f"{mod}.kernel", arr.T.copy())
        elif leaf == "weight" and arr.ndim == 4:
            put(params, f"{mod}.kernel", arr.transpose(2, 3, 1, 0).copy())
        elif leaf == "weight":
            put(params, f"{mod}.scale", arr.copy())
        else:
            put(params, name, arr.copy())
    return params, stats


@torch.no_grad()
def init_weights(model: nn.Module, seed: int = 0) -> nn.Module:
    """Seeded random initialisation, drawn on the CPU from one torch.Generator.

    Follows the JAX initialisers where they shape behaviour: the deformable
    `sampling_offsets` start at the direction grid with a zero kernel, the
    `attention_weights` at zero (uniform attention), and the level embeddings
    and queries at normal(1.0). Elsewhere: lecun-normal weights, zero biases,
    unit norms, BatchNorm running stats at (0, 1).
    """
    g = torch.Generator().manual_seed(seed)

    def normal_(t: torch.Tensor, std: float) -> None:
        t.copy_(torch.randn(t.shape, generator=g) * std)

    for module in model.modules():
        if isinstance(module, (nn.Linear, nn.Conv2d)):
            fan_in = module.weight[0].numel()
            normal_(module.weight, 1.0 / math.sqrt(fan_in))
            if module.bias is not None:
                module.bias.zero_()
        elif isinstance(module, (nn.LayerNorm, nn.GroupNorm, nn.BatchNorm2d)):
            module.weight.fill_(1.0)
            module.bias.zero_()
    for module in model.modules():  # after the generic pass, which visits parents first
        if isinstance(module, DeformableAttention):
            module.sampling_offsets.weight.zero_()
            module.sampling_offsets.bias.copy_(
                torch.from_numpy(offset_bias_grid(module.nh, module.nl, module.npts))
            )
            module.attention_weights.weight.zero_()
            module.attention_weights.bias.zero_()
    for name, p in model.named_parameters():
        leaf = name.rpartition(".")[2]
        if leaf in ("level_embed", "queries_embedder", "queries_features"):
            normal_(p, 1.0)
        elif leaf == "relative_position_bias_table":
            p.zero_()
    for name, buf in model.named_buffers():
        if name.endswith("running_mean"):
            buf.zero_()
        elif name.endswith("running_var"):
            buf.fill_(1.0)
    return model
