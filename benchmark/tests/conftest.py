"""The benchmark's tests: the repo root on the path (so `benchmark` and
`rgbdseg_torch` import), a tiny cell, and the `cuda` fixture, which skips a
test that needs the card when there is none (decided here, never at import)."""

import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

LOOSE = {"train": {"loss": 1e-3, "grad": 1e-3, "update": 1e-3},
         "eval": {"logits0": 1e-3, "logits": 1e-3, "scores": 1e-3, "stats": 1e-3, "loss": 1e-3, "map": 1e-3}}


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the port's kernels and the card's controls)")
    return torch.device("cuda:0")


def tiny_cell(kind: str, version: str = "0.4.0", bf16: bool = False, limits=None):
    """A cell of the benchmark, cut to a CPU test's size: the tiny model
    (20 queries, 64 points), 2 frames of 64x96 a batch, 5-7 instances in 12 slots."""
    from rgbdseg_torch.config import ModelConfig

    from benchmark import harness

    cfg = json.loads(ModelConfig.tiny(num_labels=5, version=version).replace(num_queries=20, train_num_points=64)
                     .to_json())
    tr = {"kind": kind, "batch": 2, "bf16": bf16, "hw": [64, 96], "slots": 12, "instances": [5, 6, 7],
          "bucket_floor": 8, "ring": 4 if kind == "train" else 3, "learning_rate": 1e-4, "epochs": 10,
          "epoch_examples": 100}
    cell = harness.load_cell("train.v040.bf16.b16" if kind == "train" else "eval.v040.f32.b8")
    cell.config, cell.traffic, cell.limits = cfg, tr, dict(LOOSE[kind] if limits is None else limits)
    return cell
