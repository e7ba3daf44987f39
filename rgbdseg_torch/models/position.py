"""Sine position embedding (counterpart of `rgbdseg_tpu/models/position.py`):
HF Mask2FormerSinePositionEmbedding with normalize=True, scale=2*pi, eps=1e-6.

Returns channels-last (H, W, 2 * num_pos_feats) in [pos_y, pos_x] order, sin and
cos interleaved, with no batch dim.

pos_y depends on the row only and pos_x on the column only, so the sines and
cosines are taken of the (H, F) and (W, F) tables and broadcast, (H + W) * F
evaluations where the JAX function takes 2 * H * W * F; the values are the
same. On the CPU this also keeps every arithmetic op of the function below
torch's parallel grain: the (15, 20, 128) division of the broadcast form ran
in two threads, and in about 3% of fresh test processes the first parallel
op gave part of the second thread's share wrong (a relative 1.15e-4 on the
sines of 32 positions, which failed `tests/test_torch_modules.py::
test_sine_position_embedding[15-20-128]`; ROADMAP.md §3).
"""

from __future__ import annotations

import math

import torch


def sine_position_embedding(
    h: int, w: int, num_pos_feats: int = 128, temperature: float = 10000.0, device=None
) -> torch.Tensor:
    eps = 1e-6
    scale = 2 * math.pi
    y = torch.arange(1, h + 1, dtype=torch.float32, device=device) / (h + eps) * scale
    x = torch.arange(1, w + 1, dtype=torch.float32, device=device) / (w + eps) * scale

    dim_t = torch.arange(num_pos_feats, dtype=torch.float32, device=device)
    dim_t = temperature ** (2 * torch.floor(dim_t / 2) / num_pos_feats)

    def table(p):  # (n,) -> (n, num_pos_feats): sin and cos interleaved
        p = p[:, None] / dim_t
        return torch.stack([p[:, 0::2].sin(), p[:, 1::2].cos()], dim=2).reshape(p.shape[0], -1)

    pos_y, pos_x = table(y), table(x)
    return torch.cat([pos_y[:, None, :].expand(h, w, -1), pos_x[None, :, :].expand(h, w, -1)], dim=-1)
