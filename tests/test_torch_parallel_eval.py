"""Eval over several processes on both of its routes (`train/trainer.py::
evaluate`, `_update_gathered`; the JAX Trainer's `_eval_update_multihost` and
its `_host_np` fallback, `rgbdseg_tpu/train/trainer.py:798-906`).

- `Evaluator.device_stats_arrays` gives the JAX method's arrays on the same
  logits and bit-packed GT: labels, areas and intersections equal, scores
  (both rounded to 6 decimals) at most one unit of the last decimal apart.
- `_update_gathered` declines the device statistics where the JAX method does
  (RGBDSEG_EVAL_DEVICE_STATS other than "1"; images of several original sizes
  evaluated at their original size), and the metric the route it chose feeds
  equals the JAX Evaluator's over the same batches (a one-rank mesh).
- In two Gloo processes on the CPU (`tests/torch_parallel_worker.py --eval`,
  the tiny 0.4.0 model with seeded weights, dp=2 and dp=1 x mp=2; each grid
  started once) `evaluate` and `predict` over 3 examples at a global batch of
  2 (the last chunk padded), under RGBDSEG_EVAL_DEVICE_STATS "1" and "0": every
  mAP key equals one process's bit for bit, the loss within rtol 1e-6, both
  ranks return equal metrics, the device-stats log line appears under "1"
  only, and `predict`'s logits are cut to the real rows, equal on both routes
  and within 1e-5 of one process's.
"""

import functools
import os
import sys
import types

import numpy as np
import pytest
import torch

from rgbdseg_tpu.data.pipeline import Batch as JBatch
from rgbdseg_tpu.train.evaluator import Evaluator as JEvaluator
from rgbdseg_torch.data.pipeline import Batch
from rgbdseg_torch.parallel.mesh import make_mesh
from rgbdseg_torch.train.evaluator import Evaluator
from rgbdseg_torch.train.trainer import _update_gathered

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_parallel_worker as W  # noqa: E402
from test_torch_eval import _gt  # noqa: E402
from test_torch_parallel import _run_workers  # noqa: E402

GRIDS = {"dp2": 1, "mp2": 2}  # two processes; the model-parallel width
SWITCHES = ["1", "0"]  # RGBDSEG_EVAL_DEVICE_STATS: the device-stats route, the host mask route
NOT_MAP = ("eval_loss", "eval_runtime", "eval_samples_per_second")


def _stats_inputs(rng, b, t, q, gt_hw, orig=None):
    """(class logits, mask logits at a quarter of gt_hw, a Batch's fields) from seeded numpy (q >= t)."""
    gh, gw = gt_hw
    masks, classes, valid = _gt(rng, b, t, gh, gw)
    fields = dict(pixel_values=np.zeros((b, gh, gw, 3), np.float32), mask_labels=masks, class_labels=classes,
                  valid=valid, orig_sizes=None if orig is None else np.asarray(orig, np.int32))
    cl = (rng.randn(b, q, 6) * 2).astype(np.float32)
    ml = rng.randn(b, q, gh // 4, gw // 4).astype(np.float32)
    # the first queries find the GT instances, so that the mAP is above 0
    ml[:, :t] += np.where(masks[:, :, ::4, ::4][:, :, :gh // 4, :gw // 4] > 0, 3.0, -3.0)
    return cl, ml, fields


@pytest.mark.parametrize("gt_hw,target_hw", [((48, 64), (48, 64)), ((45, 67), (30, 41))])
def test_device_stats_arrays_match_jax(gt_hw, target_hw):
    cl, ml, f = _stats_inputs(np.random.RandomState(3), 2, 6, 12, gt_hw)
    packed = np.packbits(f["mask_labels"].astype(bool).reshape(2, 6, -1), axis=-1)
    ids = {i: str(i) for i in range(5)}
    want = JEvaluator(ids).device_stats_arrays(cl, ml, packed, f["valid"], target_hw, gt_hw)
    got = Evaluator(ids).device_stats_arrays(torch.from_numpy(cl), torch.from_numpy(ml), packed, f["valid"],
                                             target_hw, gt_hw)
    assert all(isinstance(g, np.ndarray) for g in got)
    # the scores before rounding agree to rtol 1e-6 (`tests/test_torch_eval.py`): at most one unit of the 6th decimal
    assert np.abs(np.rint(got[0] * 1e6) - np.rint(np.asarray(want[0]) * 1e6)).max() <= 1
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g, np.asarray(w))
    assert got[4].max() > 0


@pytest.mark.parametrize("switch,at_orig,orig,takes", [
    ("1", False, None, True),
    ("1", True, [(96, 120), (96, 120)], True),
    ("1", True, [(96, 120), (60, 80)], False),
    ("0", False, None, False),
    ("0", True, [(96, 120), (96, 120)], False),
], ids=["gt-size", "one-orig-size", "mixed-orig-sizes", "switch-off", "switch-off-orig"])
def test_update_gathered_takes_device_stats_where_jax_does(monkeypatch, switch, at_orig, orig, takes):
    """The route `_update_gathered` takes on a one-rank mesh, and the metric over three batches, each fed as
    `evaluate` feeds it (the host mask path where the device statistics are declined), against the JAX Evaluator."""
    monkeypatch.setenv("RGBDSEG_EVAL_DEVICE_STATS", switch)
    rng = np.random.RandomState(4)
    ids = {i: f"c{i}" for i in range(5)}
    ours, theirs = Evaluator(ids, eval_at_original_size=at_orig), JEvaluator(ids, eval_at_original_size=at_orig)
    mesh = make_mesh(device="cpu")
    for _ in range(3):
        cl, ml, f = _stats_inputs(rng, 2, 6, 12, (48, 64), orig)
        out = types.SimpleNamespace(class_queries_logits=torch.from_numpy(cl), masks_queries_logits=torch.from_numpy(ml))
        assert _update_gathered(ours, out, Batch(**f), 2, mesh) is takes
        if not takes:
            ours.update(out.class_queries_logits, out.masks_queries_logits, Batch(**f))
        theirs.update(cl, ml, JBatch(**f))
    got, want = ours.compute(prefix="eval_"), theirs.compute(prefix="eval_")
    assert got == want
    assert want["eval_map"] > 0


@functools.lru_cache(maxsize=None)
def _reference() -> dict:
    return W.run_eval()


@pytest.fixture(scope="module")
def grids(tmp_path_factory):
    """grid -> both ranks' records, each grid's processes started once."""
    runs = {}

    def get(grid: str) -> list:
        if grid not in runs:
            runs[grid] = _run_workers(tmp_path_factory.mktemp(grid), "--eval", 2, GRIDS[grid])
        return runs[grid]

    return get


def _maps(metrics: dict) -> dict:
    return {k: v for k, v in metrics.items() if k not in NOT_MAP}


@pytest.mark.parametrize("switch", SWITCHES, ids=["device_stats", "host_masks"])
@pytest.mark.parametrize("grid", list(GRIDS))
def test_eval_in_two_processes_equals_one(grids, grid, switch):
    ref = _reference()["1"]["eval"]
    assert ref["eval_map"] > 0 and ref["eval_map_50"] > 0, "the reference's mAP is trivial"
    assert _reference()["0"]["eval"] == {**ref, **{k: _reference()["0"]["eval"][k] for k in NOT_MAP[1:]}}
    recs = grids(grid)
    for rank, rec in enumerate(recs):
        got = rec[switch]["eval"]
        assert set(got) == set(ref)
        assert _maps(got) == _maps(ref), f"rank {rank}"
        np.testing.assert_allclose(got["eval_loss"], ref["eval_loss"], rtol=1e-6)
        lines = [ln for ln in rec[switch]["lines"] if "device-stats path" in ln]
        # evaluate's two batches, then predict's evaluate's
        assert lines == (["multihost eval: device-stats path (rows=2)",
                          "multihost eval: device-stats path (rows=1)"] * 2 if switch == "1" else [])
    assert {k: v for k, v in recs[0][switch]["eval"].items() if k not in NOT_MAP[1:]} == \
        {k: v for k, v in recs[1][switch]["eval"].items() if k not in NOT_MAP[1:]}


@pytest.mark.parametrize("grid", list(GRIDS))
def test_predict_in_two_processes_on_both_routes(grids, grid):
    ref_logits, _ = _reference()["1"]["predict"]
    assert [tuple(a.shape[0] for a in b) for b in ref_logits] == [(2, 2), (1, 1)]
    for rank, rec in enumerate(grids(grid)):
        for switch in SWITCHES:
            logits, metrics = rec[switch]["predict"]
            assert _maps({k.replace("test_", "eval_"): v for k, v in metrics.items()}) == \
                _maps(rec[switch]["eval"]), f"rank {rank}, switch {switch}"
            assert len(logits) == len(ref_logits)
            for got, want, first in zip(logits, ref_logits, rec["1"]["predict"][0]):
                for g, w, f in zip(got, want, first):
                    assert g.shape == w.shape
                    assert torch.equal(g, f), "the logits depend on the eval route"
                    torch.testing.assert_close(g, w, rtol=0, atol=1e-5)
