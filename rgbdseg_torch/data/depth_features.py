"""Host-side depth features for the input pipeline (counterpart of
`rgbdseg_tpu/data/depth_features.py`, without cv2).

The reference's dataset.map-time functions, on numpy arrays:
- to_grayscale                (reference: data_process.py:1019-1129)
- compute_depth_gradient      (reference: data_process.py:1132-1169)
- calculate_gradient_features (reference: data_process.py:1247-1305)
The two gradient functions run `ops/sobel.py` on CPU tensors, in float64 where
the reference asks cv2 for CV_64F and in float32 where it asks for CV_32F.
Surface normals come with the versions that use them (ROADMAP.md).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.sobel import depth_gradient_magnitude, gradient_features


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
