"""The roofline formulas of `roofline/` reproduce the bound column of the
kernel table (PERF.md, Findings: bytes over 3.35 TB/s, each input read once
and each output written once) at the shapes given there."""

import dataclasses

import numpy as np
import pytest
import torch

from benchmark import harness, peaks
from benchmark.reference.config import Config
from benchmark.reference.criterion import uncertain_points

H100 = peaks.PEAKS["NVIDIA H100 80GB HBM3"]
OPS = harness.roofline_ops()
LEVELS = ((15, 20), (30, 40), (60, 80))
L = sum(h * w for h, w in LEVELS)


def bound_ms(op, rec):
    return peaks.bound_s(*OPS[op].cost(rec), H100) * 1e3


def k1_record(b, nh, dtype):
    value = torch.empty(b, L, nh, 32, dtype=dtype, device="meta")
    loc = torch.empty(b, L, nh, 3, 4, 2, device="meta")
    weights = torch.empty(b, L, nh, 3, 4, device="meta")
    return OPS["k1"].record(value, LEVELS, loc, weights)


@pytest.mark.parametrize("b, nh, dtype, fwd, bwd", [
    (1, 8, torch.float32, 0.0060, None),  # K1 f32, B=1
    (2, 8, torch.float32, None, 0.0202),  # K1-bwd f32, B=2
    (2, 8, torch.bfloat16, 0.0101, 0.0164),  # bf16 rows, B=2
    (1, 4, torch.float32, 0.0030, None),  # 4 heads
    (2, 4, torch.float32, None, 0.0101),
])
def test_k1(b, nh, dtype, fwd, bwd):
    rec = k1_record(b, nh, dtype)
    if fwd is not None:
        assert round(bound_ms("k1", rec), 4) == fwd
    if bwd is not None:
        assert round(bound_ms("k1_bwd", rec), 4) == bwd


@pytest.mark.parametrize("b, h, dtype, fwd, bwd", [
    (1, 8, torch.float32, (0.0003, 0.0009, 0.0036), None),
    (2, 8, torch.float32, None, (0.0011, 0.0035, 0.0131)),
    (2, 8, torch.bfloat16, (0.0003, 0.0011, 0.0041), (0.0006, 0.0019, 0.0071)),
    (1, 4, torch.float32, (0.0002, 0.0005, 0.0021), None),
    (2, 4, torch.float32, None, (0.0006, 0.0019, 0.0071)),
])
def test_k3(b, h, dtype, fwd, bwd):
    for i, nk in enumerate((300, 1200, 4800)):
        q = torch.empty(b, h, 100, 32, dtype=dtype, device="meta")
        kv = torch.empty(b, h, nk, 32, dtype=dtype, device="meta")
        rec = OPS["k3"].record(q, kv, kv, torch.empty(b, 100, nk, device="meta"),
                               torch.empty(b, 100, dtype=torch.bool, device="meta"))
        if fwd is not None:
            assert round(bound_ms("k3", rec), 4) == fwd[i], nk
        if bwd is not None:
            assert round(bound_ms("k3_bwd", rec), 4) == bwd[i], nk


def test_point_sampling():
    """B=2, 16 masks: the uncertainty pass (120x160 logits, 37632 uniform
    points), the loss (its 12544 kept points) and the labels (480x640
    targets, the same points), from seeded random logits as the table's."""
    rng = np.random.RandomState(0)
    cfg = dataclasses.replace(Config(), train_num_points=12544)
    logits = torch.from_numpy(rng.randn(2, 16, 120, 160).astype(np.float32))
    gen = torch.Generator().manual_seed(1)
    uniform = torch.rand(2, 16, 37632, 2, generator=gen)
    chosen = uncertain_points(cfg, logits, gen)
    targets = torch.empty(2, 16, 480, 640, device="meta")
    got = [round(bound_ms("ps", OPS["ps"].record(m, c)), 4) for m, c in
           ((logits, uniform), (logits, chosen), (targets, chosen))]
    assert got == [0.0050, 0.0021, 0.0031]
    assert round(bound_ms("ps_bwd", OPS["ps"].record(logits, chosen)), 4) == 0.0022
