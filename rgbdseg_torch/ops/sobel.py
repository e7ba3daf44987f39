"""Depth gradient features (Sobel), batched over leading dimensions
(counterpart of `rgbdseg_tpu/ops/sobel.py`).

- `sobel_xy`: cv2.Sobel ksize=3 (smooth [1, 2, 1], diff [-1, 0, 1]) with cv2's
  BORDER_REFLECT_101.
- `depth_gradient_magnitude`: the reference's `compute_depth_gradient`.
- `gradient_features`: the reference's `calculate_gradient_features`: invalid
  depth masked, validity = magnitude > 0, magnitudes min-max normalised per
  image over the valid ones.

On integer-valued depth (the 8-bit gray depth the builders pass) every Sobel
sum is an exact integer, so the features round only in the square root and
the normalisation, and they must have the same bits on the card as on the CPU:
- the square root is taken in float64 and rounded to float32 once: torch's
  float32 square root on the CPU is not correctly rounded (an ulp off at some
  pixels against numpy and CUDA), while the float64 one is within an ulp of
  float64, far inside float32's rounding (the sums are integers below 2^21,
  whose square roots never come within 3e-13 of a float32 midpoint);
- the normalisation divides tensor by tensor: CUDA would turn a division by a
  Python number into a product with its reciprocal.
"""

from __future__ import annotations

import torch


def _magnitude(gx: torch.Tensor, gy: torch.Tensor) -> torch.Tensor:
    """sqrt(gx^2 + gy^2) in gx's dtype, correctly rounded for float32 (see above)."""
    return torch.sqrt((gx * gx + gy * gy).to(torch.float64)).to(gx.dtype)


def _reflect101(n: int, device) -> torch.Tensor:
    """Indices of a length-n axis padded by one on each side, reflect-101."""
    return torch.cat([torch.tensor([1]), torch.arange(n), torch.tensor([n - 2])]).to(device)


def _conv1d(x: torch.Tensor, k: tuple[float, float, float], axis: int) -> torch.Tensor:
    """Correlate (..., H, W) along `axis` (-1 or -2) with a 3-tap kernel."""
    n = x.shape[axis]
    xp = x.index_select(axis, _reflect101(n, x.device))
    return k[0] * xp.narrow(axis, 0, n) + k[1] * xp.narrow(axis, 1, n) + k[2] * xp.narrow(axis, 2, n)


def sobel_xy(depth: torch.Tensor, dtype: torch.dtype = torch.float32) -> tuple[torch.Tensor, torch.Tensor]:
    """Sobel Gx, Gy of (..., H, W) depth in `dtype` (cv2 ksize=3)."""
    depth = depth.to(dtype)
    smooth, diff = (1.0, 2.0, 1.0), (-1.0, 0.0, 1.0)
    gx = _conv1d(_conv1d(depth, smooth, -2), diff, -1)
    gy = _conv1d(_conv1d(depth, diff, -2), smooth, -1)
    return gx, gy


def depth_gradient_magnitude(depth: torch.Tensor, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Raw (unnormalised) Sobel magnitude."""
    return _magnitude(*sobel_xy(depth, dtype))


def gradient_features(depth: torch.Tensor, invalid_depth_value: float = 0.0):
    """(normalised magnitude, grad x, grad y, validity mask), float32, each
    shaped like `depth`; the normalisation (mag - min_valid) / (max - min_valid)
    is per image over the last two axes."""
    depth = depth.to(torch.float32)
    valid = (depth != invalid_depth_value) & ~torch.isnan(depth)
    gx, gy = sobel_xy(depth)
    zero = torch.zeros((), dtype=torch.float32, device=depth.device)
    mag = torch.where(valid, _magnitude(gx, gy), zero)
    gx, gy = torch.where(valid, gx, zero), torch.where(valid, gy, zero)
    grad_valid = mag > 0

    flat = mag.flatten(-2)
    has_valid = grad_valid.flatten(-2).any(-1)[..., None, None]
    min_val = torch.where(grad_valid, mag, torch.inf).flatten(-2).amin(-1)[..., None, None]
    min_val = torch.where(has_valid, min_val, zero)
    max_val = flat.amax(-1)[..., None, None]
    denom = max_val - min_val
    normalized = torch.where(has_valid & (denom > 0), (mag - min_val) / denom.clamp(min=1e-30), zero)
    return normalized, gx, gy, grad_valid.to(torch.float32)
