"""Each cell's control, on the card: the reference computed in the precision
below the cell's (TF32 for a float32 cell, fp8 for the bf16 cell) in the
port's place must read `correct` false under the cell's limits. At a size a
test run holds: the cell's widths and frames, its batch cut to 2 and its ring
to 3 batches (eval: 2). The benchmark's own runs never run it;
`calibrate.py --control` reads it at the cell's own size."""

import dataclasses
import json

import pytest
import torch

from benchmark import calibrate, check, harness
from conftest import ROOT

CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_control_reads_incorrect(cuda, workload):
    cell = harness.load_cell(workload)
    ring = 3 if cell.traffic["kind"] == "train" else 2  # the reference follows three steps
    cell = dataclasses.replace(cell, traffic=dict(cell.traffic, batch=2, ring=ring))
    control = torch.float8_e4m3fn if cell.traffic["bf16"] else "tf32"
    numbers = calibrate.control_numbers(cell, 2**31 + 17, control, cuda)
    assert not check.judge(numbers, cell.limits), numbers
