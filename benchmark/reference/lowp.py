"""The reference computed in a lower precision than the configuration states:
the control that each cell's comparison must fail.

Inside `lowered(torch.float8_e4m3fn)` every operand of a product (linear
layers, convolutions, attention and mask products) is scaled by 448 over its
largest magnitude, rounded to float8 e4m3, and scaled back, as per-tensor fp8
training rounds them; sums stay float32. `lowered(torch.bfloat16)` rounds to
bfloat16. TF32, the control of a float32 cell, is a switch of torch's own
(`tf32()`), not a rounding here.

`lowered(ULP)` is no control but a witness: it clears the last bit of every
float32 operand's mantissa, a change of the size by which two sound float32
programs round apart. The reference against itself so perturbed shows how far
a seed's readings swing from rounding alone (`calibrate.py --control ulp`).
"""

from __future__ import annotations

import contextlib

import torch

_STATE = {"dtype": None}
FP8_MAX = 448.0
ULP = "ulp"


def q(x: torch.Tensor) -> torch.Tensor:
    """`x` rounded to the active lower precision (itself outside `lowered`)."""
    dt = _STATE["dtype"]
    if dt is None or not x.is_floating_point():
        return x
    if dt == ULP:
        if x.dtype != torch.float32:
            return x
        xd = x.detach()
        return x + (xd.view(torch.int32).bitwise_and(-2).view(torch.float32) - xd)
    if dt == torch.bfloat16:
        return x.to(torch.bfloat16).to(x.dtype)
    amax = x.detach().abs().amax().float().clamp(min=1e-12)
    scale = FP8_MAX / amax
    return (x * scale).to(dt).to(x.dtype) / scale


@contextlib.contextmanager
def lowered(dtype):
    """Round every product's operands to `dtype` inside the block."""
    prev = _STATE["dtype"]
    _STATE["dtype"] = dtype
    try:
        yield
    finally:
        _STATE["dtype"] = prev


@contextlib.contextmanager
def tf32(on: bool = True):
    """TF32 products in matmuls and cuDNN convolutions inside the block."""
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev
