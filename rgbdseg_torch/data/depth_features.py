"""Host-side depth features for the input pipeline (counterpart of
`rgbdseg_tpu/data/depth_features.py`, without cv2).

The reference's dataset.map-time functions, on numpy arrays:
- to_grayscale                (reference: data_process.py:1019-1129)
- compute_depth_gradient      (reference: data_process.py:1132-1169)
- calculate_gradient_features (reference: data_process.py:1247-1305)
- calculate_surface_normals   (reference: data_process.py:1308-1414, the
  intrinsics and the gradient-approximation paths)
The Sobel gradients run `ops/sobel.py` on CPU tensors, in float64 where the
reference asks cv2 for CV_64F and in float32 where it asks for CV_32F; on
integer-valued depth (the builders' 8-bit gray depth) they are exact either
way. The rest is the reference's numpy.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.sobel import depth_gradient_magnitude, gradient_features, sobel_xy


def to_grayscale(image: np.ndarray) -> np.ndarray:
    """(H, W, 3) or (H, W) -> (H, W), Rec.601 weights 0.299/0.587/0.114."""
    if image.ndim == 2:
        return image
    if image.shape[-1] == 1:
        return image[..., 0]
    return (0.299 * image[..., 0] + 0.587 * image[..., 1] + 0.114 * image[..., 2]).astype(image.dtype)


def compute_depth_gradient(depth: np.ndarray) -> np.ndarray:
    """Raw Sobel ksize=3 gradient magnitude (float64)."""
    d = torch.from_numpy(np.ascontiguousarray(depth, np.float32))
    return depth_gradient_magnitude(d, torch.float64).numpy()


def calculate_gradient_features(depth: np.ndarray, invalid_depth_value: float = 0.0):
    """(normalized_magnitude, grad_x, grad_y, valid_gradient_mask), float32."""
    d = torch.from_numpy(np.ascontiguousarray(depth, np.float32))
    return tuple(t.numpy() for t in gradient_features(d, invalid_depth_value))


def calculate_surface_normals(
    depth: np.ndarray, camera_intrinsics: dict | None = None, invalid_depth_value: float = 0.0
):
    """(unit_normals (H, W, 3) float32 in [-1, 1], valid_mask (H, W) float32)."""
    d = depth.astype(np.float32)
    h, w = d.shape
    valid = (d != invalid_depth_value) & (~np.isnan(d))

    if camera_intrinsics is not None:
        fx, fy = camera_intrinsics["fx"], camera_intrinsics["fy"]
        cx, cy = camera_intrinsics["cx"], camera_intrinsics["cy"]
        v, u = np.indices((h, w))
        z = d.copy()
        z[~valid] = np.nan
        x = (u - cx) * z / fx
        y = (v - cy) * z / fy
        pts = np.stack([x, y, z], axis=-1)
        dp_du = np.gradient(pts, axis=1)
        dp_dv = np.gradient(pts, axis=0)
        normals = np.cross(dp_du.reshape(-1, 3), dp_dv.reshape(-1, 3)).reshape(h, w, 3)
    else:
        gx, gy = (t.numpy() for t in sobel_xy(torch.from_numpy(np.ascontiguousarray(d))))
        gx[~valid] = 0
        gy[~valid] = 0
        normals = np.stack([-gx, -gy, np.ones_like(gx)], axis=-1)

    norm = np.linalg.norm(normals, axis=-1, keepdims=True)
    norm[norm == 0] = 1e-6
    norm[np.isnan(norm)] = 1e-6
    unit = normals / norm
    invalid = ~valid | np.isnan(unit).any(axis=-1)
    unit[invalid] = 0
    valid_mask = (np.linalg.norm(unit, axis=-1) > 1e-5).astype(np.float32)
    return unit.astype(np.float32), valid_mask
