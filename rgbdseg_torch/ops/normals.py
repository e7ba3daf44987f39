"""Surface normals from depth, batched over leading dimensions
(counterpart of `rgbdseg_tpu/ops/normals.py`; reference data_process.py:1308-1414).

- `surface_normals_gradient`: normals proportional to (-Gx, -Gy, 1) from the
  Sobel ksize=3 gradients of `ops/sobel.py`;
- `surface_normals_intrinsics`: the depth back-projected with (fx, fy, cx,
  cy) to 3-D points, np.gradient along u and v (central differences inside,
  one-sided at the borders), their cross product, normalised.

Invalid depth (the invalid value or NaN) gives a zero normal and a zero
validity. On integer-valued depth (the 8-bit gray depth of `map_7channel_s`)
the gradient method's sum of squares is an exact integer, and its square root
is taken in float64 and rounded once, as `ops/sobel.py` does: torch's float32
root on the CPU is not correctly rounded, and the card's and the CPU's
normals must have the same bits.

`surface_normals_intrinsics` puts NaN into the points of invalid pixels, as the
JAX op does, so that their neighbours' differences turn invalid too: its
gradient is NaN there. The model calls it on detached intrinsics, as the JAX
model stops the gradient at its output (`models/mask2former.py`).
"""

from __future__ import annotations

import torch

from .sobel import sobel_xy


def _norm(v: torch.Tensor) -> torch.Tensor:
    """Euclidean norm over the last axis (3 components), keepdim, rooted in float64."""
    sq = v[..., 0:1] * v[..., 0:1] + v[..., 1:2] * v[..., 1:2] + v[..., 2:3] * v[..., 2:3]
    return torch.sqrt(sq.to(torch.float64)).to(v.dtype)


def _unit(normals: torch.Tensor, norm: torch.Tensor, valid: torch.Tensor):
    unit = normals / norm
    invalid = ~valid | torch.isnan(unit).any(-1)
    unit = torch.where(invalid[..., None], torch.zeros((), dtype=unit.dtype, device=unit.device), unit)
    return unit, (_norm(unit)[..., 0] > 1e-5).to(torch.float32)


def surface_normals_gradient(depth: torch.Tensor, invalid_depth_value: float = 0.0):
    """(..., H, W) depth -> (unit normals (..., H, W, 3), validity (..., H, W)), float32."""
    depth = depth.to(torch.float32)
    valid = (depth != invalid_depth_value) & ~torch.isnan(depth)
    gx, gy = sobel_xy(depth)
    zero = torch.zeros((), dtype=torch.float32, device=depth.device)
    gx, gy = torch.where(valid, gx, zero), torch.where(valid, gy, zero)
    normals = torch.stack([-gx, -gy, torch.ones_like(gx)], dim=-1)
    norm = _norm(normals)
    norm = torch.where(norm == 0, torch.full_like(norm, 1e-6), norm)
    return _unit(normals, norm, valid)


def np_gradient(x: torch.Tensor, dim: int) -> torch.Tensor:
    """np.gradient along `dim`: central differences, one-sided at the borders."""
    n = x.shape[dim]
    interior = (x.narrow(dim, 2, n - 2) - x.narrow(dim, 0, n - 2)) / 2.0
    first = x.narrow(dim, 1, 1) - x.narrow(dim, 0, 1)
    last = x.narrow(dim, n - 1, 1) - x.narrow(dim, n - 2, 1)
    return torch.cat([first, interior, last], dim=dim)


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """jnp.cross over the last axis, component by component."""
    return torch.stack([
        a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0],
    ], dim=-1)


def surface_normals_intrinsics(depth: torch.Tensor, fx: torch.Tensor, fy: torch.Tensor, cx: torch.Tensor,
                               cy: torch.Tensor, invalid_depth_value: float = 0.0):
    """(B, H, W) depth and (B,) intrinsics -> (unit normals (B, H, W, 3), validity (B, H, W)), float32."""
    depth = depth.to(torch.float32)
    b, h, w = depth.shape
    valid = (depth != invalid_depth_value) & ~torch.isnan(depth)
    z = torch.where(valid, depth, torch.full((), float("nan"), device=depth.device))
    v = torch.arange(h, dtype=torch.float32, device=depth.device)[:, None]
    u = torch.arange(w, dtype=torch.float32, device=depth.device)[None, :]

    def per_image(t):
        return t.to(torch.float32).reshape(b, 1, 1)

    x = (u - per_image(cx)) * z / per_image(fx)
    y = (v - per_image(cy)) * z / per_image(fy)
    points = torch.stack([x, y, z], dim=-1)
    normals = _cross(np_gradient(points, 2), np_gradient(points, 1))
    norm = _norm(normals)
    norm = torch.where((norm == 0) | torch.isnan(norm), torch.full_like(norm, 1e-6), norm)
    return _unit(normals, norm, valid)
