"""The harness's control flow at a tiny size on the CPU (the command itself
needs a card), its result line, its arithmetic against brute force, and its
discovery of a configuration, a traffic mix and a metric added as files."""

import json
import shutil
import subprocess
import sys
import time

import numpy as np
import pytest

from benchmark import harness, readers, trace
from conftest import ROOT, tiny_cell

LINE_KEYS = {"correct", "attempted", "failed", "metrics", "device", "kernel_build", "checks"}


@pytest.mark.parametrize("kind", ["train", "eval"])
@pytest.mark.parametrize("traced", [False, True])
def test_cell_end_to_end_on_cpu(kind, traced):
    cell = tiny_cell(kind)
    run = harness.KINDS[kind](cell, 2**31 + 7, 1.0, traced, "cpu", time.time())
    line = harness.result(run, traced)
    assert set(line) - {"breakdown"} == LINE_KEYS and list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] >= 1
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    if traced:
        assert {"busy_s", "window_s"} <= set(line["device"]) and set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        assert run.reading.steps == harness.TRACE_STEPS[kind]
        assert any(c.op.startswith("k1") for c in run.reading.calls)
        assert run.flops_per_step > 0
    else:
        rate = next(m["name"] for m in cell.end_to_end if m["name"] != "setup_s")
        assert set(line["metrics"]) == {rate, "setup_s"}
        assert line["metrics"][rate]["value"] == pytest.approx(run.images / run.window_s)
    json.dumps(line)


def test_command_without_card_prints_no_result():
    proc = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "train.v040.bf16.b16", "--seed", "1",
                           "--seconds", "1", "--trace", "0"], cwd=ROOT, capture_output=True, text=True, timeout=300)
    import torch

    if not torch.cuda.is_available():
        assert proc.returncode != 0 and proc.stdout == ""


@pytest.mark.parametrize("seed", range(5))
def test_interval_union_and_idle_share_against_brute_force(seed):
    rng = np.random.default_rng(seed)
    starts = rng.integers(0, 1000, 40)
    pairs = [(int(s), int(s + d)) for s, d in zip(starts, rng.integers(0, 60, 40))]
    covered = np.zeros(1100, bool)
    for s, e in pairs:
        covered[s:e] = True
    assert trace.interval_union(pairs) == covered.sum()
    events = [{"ph": "X", "cat": "kernel", "name": "k", "ts": s, "dur": e - s} for s, e in pairs]
    events.append({"ph": "X", "cat": "cpu_op", "name": "x", "ts": 0, "dur": 5000})
    reading = trace.Reading(events, (100, 900), 4, [], 0.0005)
    assert reading.busy_us() == covered[100:900].sum()
    run = harness.Run(tiny_cell("train"), harness.torch.device("cpu"), reading=reading)
    assert readers.idle(run) == pytest.approx(100 * (1 - covered[100:900].sum() / 1e6 / 4 / 0.0005))
    assert reading.launches() == sum(1 for s, _ in pairs if 100 <= s < 900)
    gaps = sum(g for _, g in reading.idle_gaps(n=1000))
    assert gaps * 1e6 == pytest.approx(800 - covered[100:900].sum())


CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.parametrize("workload", CELLS)
def test_rate_is_images_over_window(workload):
    cell = harness.load_cell(workload)
    run = harness.Run(cell, harness.torch.device("cpu"), setup_s=3.0, window_s=2.5, steps=5, images=10)
    line = harness.result(run, False)
    rates = [m["name"] for m in cell.end_to_end if m["name"] != "setup_s"]
    assert len(rates) == 1 and line["metrics"][rates[0]]["value"] == 4.0
    assert line["metrics"]["setup_s"]["value"] == 3.0


def test_discovers_files_added_by_name(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(ROOT / "benchmark", root / "benchmark", ignore=shutil.ignore_patterns("__pycache__", "tests"))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    config = json.loads((ROOT / "benchmark/configs/m2f-swint-rgbd-v040.json").read_text())
    (root / "benchmark/configs/new-config.json").write_text(json.dumps(dict(config, num_queries=50)))
    (root / "benchmark/traffic/new.mix.json").write_text(json.dumps({"kind": "eval", "batch": 2, "bf16": False,
                                                                      "hw": [64, 96], "slots": 4, "instances": [1],
                                                                      "bucket_floor": 8, "ring": 1}))
    (root / "benchmark/metrics/new_metric.eval.py").write_text("def read(run):\n    return 42.0\n")
    spec["configs"].append({"name": "new-config", "source": "x", "file": "benchmark/configs/new-config.json",
                            "reduced": [], "why": "x"})
    spec["workloads"].append({"name": "new.cell", "config": "new-config", "traffic": "new.mix", "chips": 1, "why": "x"})
    spec["per_layer"].append({"name": "new_metric.eval", "unit": "%", "better": "higher", "source": "program_span",
                              "layer": "x", "moves": "eval_img_s", "workloads": ["new.cell"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    cell = harness.load_cell("new.cell", root)
    assert cell.config["num_queries"] == 50 and cell.traffic["batch"] == 2
    assert [m["name"] for m in cell.per_layer] == ["new_metric.eval"]
    assert harness.metric_reader("new_metric.eval", root).read(None) == 42.0
