"""The readers of the program's own spans and counters (`program.py`) on
hand-built traces: nested spans, a span on a second thread, gaps across span
boundaries, the latest-started rule, the scaling to the window's step time,
None where there is nothing to read; then against brute force, and on the
tiny cells' traced runs on the CPU."""

import sys
import time
from types import SimpleNamespace

import numpy as np
import pytest

from benchmark import harness, program
from benchmark.trace import Reading
from conftest import tiny_cell


def span(name, ts, end, tid=1):
    return {"ph": "X", "cat": "user_annotation", "name": "rgbdseg." + name, "ts": ts, "dur": end - ts,
            "tid": tid, "pid": 1}


def kernel(ts, end, corr=None):
    return {"ph": "X", "cat": "kernel", "name": "k", "ts": ts, "dur": end - ts, "args": {"correlation": corr}}


def launch(ts, corr, tid=1):
    return {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": ts, "dur": 1, "tid": tid,
            "pid": 1, "args": {"correlation": corr}}


def run_of(events, window=(0, 100), steps=2, step_s=50e-6):
    return SimpleNamespace(reading=Reading(events, window, steps, [], step_s))


# Busy [0, 10], [40, 50], [90, 100]: idle [10, 40] and [50, 90], 70 µs in 2 steps of 50 µs (35 idle each).
TRACE = [kernel(0, 10), kernel(40, 50), kernel(90, 100),
         span("train.step", 0, 100), span("matcher", 5, 30), span("matcher.copy", 12, 25),
         span("apply_step", 30, 70), span("host.gc", 60, 65), span("op.k1_bwd", 75, 85, tid=2)]


def test_each_idle_instant_goes_to_the_latest_started_open_span():
    r = run_of(TRACE).reading
    spans = program.program_spans(r)
    att, unlabelled, total = program.idle_attribution(r, spans)
    by_name = {}
    for i, us in att.items():
        by_name[spans[i]["name"]] = by_name.get(spans[i]["name"], 0) + us
    # [10, 12) matcher, [12, 25) its copy, [25, 30) matcher, [30, 40) apply_step; [50, 60) apply_step,
    # [60, 65) host.gc, [65, 70) apply_step, [70, 75) train.step, [75, 85) the second thread's op, [85, 90) train.step
    assert by_name == {"matcher": 7, "matcher.copy": 13, "apply_step": 25, "host.gc": 5, "train.step": 10,
                       "op.k1_bwd": 10}
    assert (unlabelled, total) == (0, 70)


def test_a_span_counts_the_spans_nested_in_it_but_gc_only_for_itself():
    run = run_of(TRACE)
    per_step_ms = 0.035  # the window's 50 µs a step less the 15 µs busy
    assert program.idle_ms(run, "matcher") == pytest.approx(20 / 70 * per_step_ms)
    assert program.idle_ms(run, "matcher.copy") == pytest.approx(13 / 70 * per_step_ms)
    assert program.idle_ms(run, "apply_step") == pytest.approx(25 / 70 * per_step_ms)
    assert program.idle_ms(run, "host.gc") == pytest.approx(5 / 70 * per_step_ms)
    # the step holds all of its thread's spans but the collector's; the other thread's span is not in it
    assert program.idle_ms(run, "train.step") == pytest.approx(55 / 70 * per_step_ms)
    assert program.idle_ms(run, "op.k1_bwd") == pytest.approx(10 / 70 * per_step_ms)
    assert program.idle_ms(run, "upload") == 0.0
    parts = sum(program.idle_ms(run, n) for n in ("matcher", "apply_step", "host.gc", "op.k1_bwd"))
    assert parts <= per_step_ms


def test_scaled_to_the_window_step_time_not_the_stretch():
    slow = program.idle_ms(run_of(TRACE, step_s=115e-6), "apply_step")  # 100 µs idle a step
    assert slow == pytest.approx(25 / 70 * 0.1)


def test_idle_under_no_span_and_the_tie_of_two_starts():
    events = [kernel(0, 10), kernel(30, 40), span("outer", 10, 25), span("inner", 10, 20)]
    r = run_of(events, window=(0, 40), steps=1, step_s=60e-6).reading
    spans = program.program_spans(r)
    att, unlabelled, total = program.idle_attribution(r, spans)
    names = {spans[i]["name"]: us for i, us in att.items()}
    assert names == {"inner": 10, "outer": 5} and (unlabelled, total) == (5, 20)


def test_none_where_nothing_to_read():
    assert program.idle_ms(run_of([kernel(0, 100)] + TRACE[3:]), "apply_step") is None  # the card never idles
    assert program.idle_ms(run_of(TRACE, step_s=10e-6), "apply_step") is None  # busy exceeds the window's step
    assert program.idle_ms(run_of(TRACE[:3]), "apply_step") is None  # a program without spans
    assert program.idle_ms(SimpleNamespace(reading=None), "apply_step") is None
    assert program.device_ms(run_of(TRACE[:3]), "model.fusion") is None


def test_device_ms_joins_launches_inside_the_span_on_its_thread():
    events = [span("model.fusion", 10, 20), span("model.fusion", 60, 70), launch(12, 1), launch(25, 2),
              launch(15, 3, tid=2), launch(65, 4), kernel(30, 37, corr=1), kernel(40, 90, corr=2),
              kernel(50, 60, corr=3), kernel(70, 73, corr=4)]
    assert program.device_ms(run_of(events, steps=2), "model.fusion") == pytest.approx((7 + 3) / 2 / 1e3)


def test_map_compute_ms(monkeypatch):
    from rgbdseg_torch.utils import trace as port

    monkeypatch.setitem(port.COUNTERS, "map", {"compute_s": 1.5, "images": 500})
    assert program.map_compute_ms(None) == pytest.approx(3.0)
    monkeypatch.setitem(port.COUNTERS, "map", {"compute_s": 0.0, "images": 0})
    assert program.map_compute_ms(None) is None
    monkeypatch.setitem(sys.modules, "rgbdseg_torch.utils.trace", None)  # a port without the tracer
    assert program.map_compute_ms(None) is None


@pytest.mark.parametrize("seed", range(6))
def test_attribution_against_brute_force(seed):
    rng = np.random.default_rng(seed)
    events = []
    for _ in range(30):
        s = int(rng.integers(0, 1000))
        events.append(kernel(s, s + int(rng.integers(1, 40))))
    for i in range(25):
        s = int(rng.integers(-50, 1000))
        events.append(span(f"s{i}", s, s + int(rng.integers(1, 300)), tid=int(rng.integers(1, 3))))
    r = run_of(events, window=(0, 1000), steps=1, step_s=1e-3).reading
    spans = program.program_spans(r)
    att, unlabelled, total = program.idle_attribution(r, spans)
    busy = np.zeros(1000, bool)
    for ev in events[:30]:
        busy[ev["ts"]:ev["ts"] + ev["dur"]] = True
    want, none = {}, 0
    for t in np.nonzero(~busy)[0]:
        open_ = [i for i, sp in enumerate(spans) if sp["ts"] <= t < sp["end"]]
        if open_:
            label = max(open_, key=lambda i: (spans[i]["ts"], -spans[i]["end"]))
            want[label] = want.get(label, 0) + 1
        else:
            none += 1
    assert att == want and unlabelled == none and total == (~busy).sum()


@pytest.mark.parametrize("kind", ["train", "eval"])
def test_new_metrics_read_on_the_traced_tiny_cells(kind):
    cell = tiny_cell(kind)
    new = [m for m in cell.per_layer
           if m["name"].split(".")[0] in ("idle_upload_ms", "idle_cast_ms", "idle_optimizer_ms", "idle_matcher_ms",
                                          "idle_gc_ms", "fusion_fwd_ms", "map_compute_ms")]
    assert len(new) == (6 if kind == "train" else 5)  # the bf16 train cell's and the eval cell's
    run = harness.KINDS[kind](cell, 2**31 + 11, 1.0, True, "cpu", time.time())
    line = harness.result(run, True)
    values = {m["name"]: line["metrics"][m["name"]]["value"] for m in new}
    idle = {k: v for k, v in values.items() if k.startswith("idle_")}
    assert all(v >= 0 for v in idle.values())
    assert sum(idle.values()) <= program.idle_per_step_us(run.reading) / 1e3 + 1e-9
    assert values[next(k for k in values if k.startswith("fusion_fwd_ms"))] == 0.0  # no device work on the CPU
    if kind == "eval":
        assert values["map_compute_ms.eval"] > 0
