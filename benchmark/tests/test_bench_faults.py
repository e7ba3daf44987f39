"""A run with its timed path broken underneath must read `correct` false:
drive the rest of a run at a tiny size on the CPU (the look for a card
skipped) with each fault the cell can have planted, under limits no sound
run comes near. The sound run reads `correct` true under the same limits."""

import time

import pytest
import torch

from benchmark import harness
from conftest import tiny_cell

from conftest import LOOSE


def _run(kind, faults=(), bf16=False):
    cell = tiny_cell(kind, bf16=bf16)
    run = harness.KINDS[kind](cell, 2**31 + 11, 0.5, False, "cpu", time.time(), faults)
    return harness.result(run, False)


@pytest.mark.parametrize("kind", ["train", "eval"])
def test_sound_run_is_correct(kind):
    assert _run(kind)["correct"] is True


def test_state_unchanged_is_caught():
    line = _run("train", ("unchanged",))
    assert line["correct"] is False and line["checks"]["update"]["value"] == pytest.approx(1.0)


def test_half_batch_is_caught():
    line = _run("train", ("half_batch",))
    assert line["correct"] is False and line["checks"]["loss"]["value"] > LOOSE["train"]["loss"]


def test_altered_answer_is_caught():
    line = _run("eval", ("altered",))
    assert line["correct"] is False and line["checks"]["logits0"]["value"] > LOOSE["eval"]["logits0"]


def test_bf16_policy_against_float32_reference():
    """The bf16 cell's program (bf16 policy) reads within the bf16 cell's limits
    of the float32 reference at the tiny size, and the fp8 control reads far above."""
    from benchmark import calibrate, check

    line = _run("train", bf16=True)
    assert max(c["value"] for c in line["checks"].values()) < 0.1
    cell = tiny_cell("train", bf16=True)
    control = calibrate.control_numbers(cell, 5, torch.float8_e4m3fn, "cpu")
    assert control["loss"] > line["checks"]["loss"]["value"]
    assert check.judge(control, {"loss": line["checks"]["loss"]["value"] * 3, "grad": 1.0, "update": 1.0}) is False
