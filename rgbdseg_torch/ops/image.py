"""Rec.601 grayscale with the reference's weights 0.299/0.587/0.114
(counterpart of `rgbdseg_tpu/ops/image.py::to_grayscale`)."""

from __future__ import annotations

import torch

REC601 = (0.299, 0.587, 0.114)


def to_grayscale(x: torch.Tensor) -> torch.Tensor:
    """Channels-last RGB (..., H, W, 3) or grayscale (..., H, W, 1) -> (..., H, W).

    Written as three elementwise products summed in a fixed order, so the CPU
    and the GPU round identically: the DSAM histogram downstream bins these
    values, and a one-ulp difference could move a pixel across a bin edge.
    A bfloat16 input is weighed as the JAX package's `x @ w` with w in x's
    dtype: the weights rounded to bfloat16, the products summed in float32,
    the sum rounded once to bfloat16.
    """
    if x.shape[-1] == 1:
        return x[..., 0]
    if x.shape[-1] != 3:
        raise ValueError(f"expected 1 or 3 channels, got {x.shape[-1]}")
    if x.dtype == torch.float32:
        r, g, b = REC601
        return x[..., 0] * r + x[..., 1] * g + x[..., 2] * b
    r, g, b = torch.tensor(REC601, dtype=x.dtype).tolist()
    xf = x.float()
    return (xf[..., 0] * r + xf[..., 1] * g + xf[..., 2] * b).to(x.dtype)
