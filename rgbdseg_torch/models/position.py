"""Sine position embedding (counterpart of `rgbdseg_tpu/models/position.py`):
HF Mask2FormerSinePositionEmbedding with normalize=True, scale=2*pi, eps=1e-6.

Returns channels-last (H, W, 2 * num_pos_feats) in [pos_y, pos_x] order, sin and
cos interleaved, with no batch dim.
"""

from __future__ import annotations

import math

import torch


def sine_position_embedding(
    h: int, w: int, num_pos_feats: int = 128, temperature: float = 10000.0, device=None
) -> torch.Tensor:
    eps = 1e-6
    scale = 2 * math.pi
    y = torch.arange(1, h + 1, dtype=torch.float32, device=device)[:, None].expand(h, w)
    x = torch.arange(1, w + 1, dtype=torch.float32, device=device)[None, :].expand(h, w)
    y = y / (h + eps) * scale
    x = x / (w + eps) * scale

    dim_t = torch.arange(num_pos_feats, dtype=torch.float32, device=device)
    dim_t = temperature ** (2 * torch.floor(dim_t / 2) / num_pos_feats)

    pos_x = x[:, :, None] / dim_t
    pos_y = y[:, :, None] / dim_t
    pos_x = torch.stack([pos_x[:, :, 0::2].sin(), pos_x[:, :, 1::2].cos()], dim=3).reshape(h, w, -1)
    pos_y = torch.stack([pos_y[:, :, 0::2].sin(), pos_y[:, :, 1::2].cos()], dim=3).reshape(h, w, -1)
    return torch.cat([pos_y, pos_x], dim=-1)
