"""The card's published peaks (NVIDIA's H100 SXM data sheet, dense, at its
700 W limit), by the longest prefix of `torch.cuda.get_device_name()`.

`mfu` divides by the dense rate of the step's precision: bfloat16 on the
tensor cores, or float32 outside them (TF32 off). A kernel's roofline divides
its operations by the rate of its operand dtype on the tensor cores (TF32 for
float32 operands: no implementation of a float32 op can beat it) and its
bytes by the HBM bandwidth.
"""

from __future__ import annotations

PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "mfu": {"bfloat16": 989.4e12, "float32": 66.9e12},
        "ops": {"torch.bfloat16": 989.4e12, "torch.float32": 494.7e12},
        "bytes_per_s": 3.35e12,
    },
}


def for_device(kind: str):
    """The peaks of the card named `kind`, or None for a card not in the table."""
    matches = [k for k in PEAKS if kind.startswith(k)]
    return PEAKS[max(matches, key=len)] if matches else None


def bound_s(flops: float, nbytes: float, dtype: str, peaks: dict) -> float:
    """The least time the card could take: the larger of operations over the
    dtype's rate and bytes over the bandwidth."""
    return max(flops / peaks["ops"][dtype], nbytes / peaks["bytes_per_s"])
