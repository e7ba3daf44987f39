"""Resize and adaptive-pool primitives, channels-last like the JAX package
(counterpart of `rgbdseg_tpu/ops/resize.py`).

- `resize_bilinear`: torch ``align_corners=False`` half-pixel sampling with the
  source coordinate clamped to [0, in-1], no antialias.
- `resize_nearest`: the explicit ``floor(dst * in/out)`` index, computed in
  float32 as the JAX package computes it (not ``F.interpolate(mode="nearest")``,
  whose own scale arithmetic can differ at boundaries).
- `adaptive_max_pool2d` / `adaptive_avg_pool2d`: torch's adaptive pooling.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _linear_weights(out_size: int, in_size: int, device):
    """(lo_idx, hi_idx, hi_weight) for 1-D linear interpolation."""
    i = torch.arange(out_size, dtype=torch.float32, device=device)
    src = (i + 0.5) * (in_size / out_size) - 0.5
    src = src.clamp(0.0, in_size - 1)
    lo = torch.floor(src)
    w = src - lo
    lo = lo.long()
    hi = (lo + 1).clamp(max=in_size - 1)
    return lo, hi, w


def resize_bilinear(x: torch.Tensor, size: tuple[int, int]) -> torch.Tensor:
    """Bilinear resize of (..., H, W, C); rows first, then columns."""
    out_h, out_w = size
    *lead, in_h, in_w, c = x.shape
    if (in_h, in_w) == (out_h, out_w):
        return x
    lo_y, hi_y, wy = _linear_weights(out_h, in_h, x.device)
    lo_x, hi_x, wx = _linear_weights(out_w, in_w, x.device)
    x = x.reshape(-1, in_h, in_w, c)
    wy = wy.to(x.dtype)[None, :, None, None]
    rows = x[:, lo_y] * (1 - wy) + x[:, hi_y] * wy
    wx = wx.to(x.dtype)[None, None, :, None]
    out = rows[:, :, lo_x] * (1 - wx) + rows[:, :, hi_x] * wx
    return out.reshape(*lead, out_h, out_w, c)


def nearest_indices(out_size: int, in_size: int, device=None) -> torch.Tensor:
    """torch ``mode='nearest'`` source index ``floor(dst * in/out)``, in float32."""
    src = torch.arange(out_size, dtype=torch.float32, device=device) * (in_size / out_size)
    return src.long().clamp(max=in_size - 1)


def resize_nearest(x: torch.Tensor, size: tuple[int, int]) -> torch.Tensor:
    """Nearest resize of (..., H, W, C)."""
    out_h, out_w = size
    *lead, in_h, in_w, c = x.shape
    if (in_h, in_w) == (out_h, out_w):
        return x
    x = x.reshape(-1, in_h, in_w, c)
    out = x[:, nearest_indices(out_h, in_h, x.device)][:, :, nearest_indices(out_w, in_w, x.device)]
    return out.reshape(*lead, out_h, out_w, c)


def _adaptive(fn, x: torch.Tensor, size: tuple[int, int]) -> torch.Tensor:
    *lead, in_h, in_w, c = x.shape
    # NCHW-contiguous input: on channels-last strides the CUDA average pool takes
    # its NHWC kernel, 30.8 ms for the E-DSAM pool of a 480x640 train batch
    # against 0.8 ms for the NCHW one.
    y = fn(x.reshape(-1, in_h, in_w, c).permute(0, 3, 1, 2).contiguous(), size)
    return y.permute(0, 2, 3, 1).reshape(*lead, *size, c)


def adaptive_max_pool2d(x: torch.Tensor, size: tuple[int, int]) -> torch.Tensor:
    """torch ``adaptive_max_pool2d`` on (..., H, W, C) (DSAM mask downsampling)."""
    return _adaptive(F.adaptive_max_pool2d, x, tuple(size))


def adaptive_avg_pool2d(x: torch.Tensor, size: tuple[int, int]) -> torch.Tensor:
    """torch ``adaptive_avg_pool2d`` on (..., H, W, C) (E-DSAM predictor)."""
    return _adaptive(F.adaptive_avg_pool2d, x, tuple(size))
