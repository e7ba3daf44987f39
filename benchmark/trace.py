"""The traced run's instrumentation and the reduction of its trace.

Spans are placed by the benchmark, in traced runs only, around the port's
functions named in `spans.json` and around the public entry points of the
hand kernels named by the files of `roofline/`. A kernel entry's backward
gets a span too, opened and closed by pre-hook and hook of the autograd node
that the entry's output carries, which run on the autograd thread. A span is a
`torch.profiler.record_function` named `bench.<name>`; an op's span adds
`#<call index>`, so that the call's recorded shapes give its bound.

`torch.profiler`'s Chrome trace (written under the checkout's `build/`,
read, then removed) gives the device intervals (kernels, copies and memsets),
the launches (CUDA runtime and driver calls, joined to their kernels by the
trace's correlation ids) and the spans.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib
import json
import os
import sys
from pathlib import Path

import torch

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATEGORIES = ("cuda_runtime", "cuda_driver", "runtime", "driver")
PREFIX = "bench."


def interval_union(pairs) -> float:
    """Total length covered by the (start, end) intervals, overlaps counted once."""
    total, covered_to = 0.0, float("-inf")
    for s, e in sorted(pairs):
        if e > covered_to:
            total += e - max(s, covered_to)
            covered_to = e
    return total


def merged(pairs) -> list:
    """The (start, end) intervals merged where they overlap or touch, in order."""
    out = []
    for s, e in sorted(pairs):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [tuple(p) for p in out]


def device_intervals(events) -> list:
    """(start, end) in µs of the work on the card: kernels, copies and memsets."""
    return [(e["ts"], e["ts"] + e.get("dur", 0)) for e in events
            if e.get("ph") == "X" and e.get("cat") in DEVICE_CATEGORIES]


def resolve(target: str):
    """"module:attr" or "module:Class.attr" -> (owner, attribute name, object)."""
    mod_name, _, path = target.partition(":")
    owner = importlib.import_module(mod_name)
    *parents, attr = path.split(".")
    for p in parents:
        owner = getattr(owner, p)
    return owner, attr, getattr(owner, attr)


def _rebind(owner, attr, old, new) -> list:
    """Put `new` where `old` is bound: on its owner and, for a module-level
    function, in every loaded module of the port that imported it by name.
    Returns the (module or class, attribute, old) bindings replaced."""
    done = [(owner, attr, old)]
    setattr(owner, attr, new)
    if not isinstance(owner, type):
        for name, mod in list(sys.modules.items()):
            if name.split(".")[0] == "rgbdseg_torch" and mod is not owner:
                for key, val in list(vars(mod).items()):
                    if val is old:
                        setattr(mod, key, new)
                        done.append((mod, key, old))
    return done


@dataclasses.dataclass
class OpCall:
    op: str
    index: int
    record: dict


class Spans:
    """Installs the spans, collects the op calls' records, and takes them out again."""

    def __init__(self, span_targets: dict, ops: dict):
        self.span_targets, self.ops = span_targets, ops
        self.calls: list = []
        self.recording = False
        self._undo: list = []

    def install(self) -> None:
        for name, target in self.span_targets.items():
            owner, attr, fn = resolve(target)
            self._undo += _rebind(owner, attr, fn, self._span(name, fn))
        backward = {m.BACKWARD_OF: op for op, m in self.ops.items() if getattr(m, "BACKWARD_OF", None)}
        for op, m in self.ops.items():
            if getattr(m, "ENTRY", None):
                owner, attr, fn = resolve(m.ENTRY)
                self._undo += _rebind(owner, attr, fn, self._op(op, m, backward.get(op), fn))

    def uninstall(self) -> None:
        for owner, attr, old in reversed(self._undo):
            setattr(owner, attr, old)
        self._undo = []

    @staticmethod
    def _span(name, fn):
        def wrapped(*args, **kwargs):
            with torch.profiler.record_function(PREFIX + name):
                return fn(*args, **kwargs)

        wrapped.__wrapped__ = fn
        return wrapped

    def _op(self, op, module, bwd_op, fn):
        spans = self

        def wrapped(*args, **kwargs):
            if not spans.recording:
                return fn(*args, **kwargs)
            call = OpCall(op, len(spans.calls), module.record(*args, **kwargs))
            spans.calls.append(call)
            with torch.profiler.record_function(f"{PREFIX}op.{op}#{call.index}"):
                out = fn(*args, **kwargs)
            node = getattr(out, "grad_fn", None)
            if bwd_op is not None and node is not None:
                bcall = OpCall(bwd_op, len(spans.calls), call.record)
                spans.calls.append(bcall)
                handle = {}

                def pre(grad_outputs):
                    handle["h"] = torch.ops.profiler._record_function_enter_new(f"{PREFIX}op.{bwd_op}#{bcall.index}")

                def post(grad_inputs, grad_outputs):
                    if "h" in handle:
                        torch.ops.profiler._record_function_exit(handle.pop("h"))

                node.register_prehook(pre)
                node.register_hook(post)
            return out

        wrapped.__wrapped__ = fn
        return wrapped


@contextlib.contextmanager
def backward_span():
    """A span around every `Tensor.backward` in the block."""
    original = torch.Tensor.backward

    def backward(self, *args, **kwargs):
        with torch.profiler.record_function(PREFIX + "backward"):
            return original(self, *args, **kwargs)

    torch.Tensor.backward = backward
    try:
        yield
    finally:
        torch.Tensor.backward = original


class Profile:
    """torch.profiler over a stretch of the window: `start()`, `stop()` once
    the stretch's last step has synchronised, `read()` after the window."""

    def __init__(self, build_dir: Path):
        self.build_dir = build_dir
        self.prof = None
        self.events = None
        self._window = None

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        cuda = torch.cuda.is_available()
        if cuda:
            torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else []),
                            acc_events=True)
        self.prof.start()
        self._window = torch.ops.profiler._record_function_enter_new(PREFIX + "window")

    def stop(self) -> None:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        torch.ops.profiler._record_function_exit(self._window)
        self.prof.stop()

    def read(self) -> list:
        """The stretch's Chrome trace events (after the window: the export takes seconds)."""
        self.build_dir.mkdir(parents=True, exist_ok=True)
        path = self.build_dir / "trace.json"
        try:
            self.prof.export_chrome_trace(str(path))
            with open(path) as f:
                self.events = json.load(f)["traceEvents"]
        finally:
            if path.exists():
                os.remove(path)
        self.prof = None
        return self.events


@dataclasses.dataclass
class Reading:
    """What the readers of the per-layer metrics read from one traced stretch."""

    events: list
    window: tuple  # (start, end) µs of the `bench.window` span
    steps: int  # steps or batches in the stretch
    calls: list  # OpCall of each op span, by index
    step_s: float  # wall seconds per step or batch of the window outside the stretch (host clock)

    @property
    def device(self) -> list:
        s, e = self.window
        return [(max(a, s), min(b, e)) for a, b in device_intervals(self.events) if b > s and a < e]

    def busy_us(self) -> float:
        return interval_union(self.device)

    def window_us(self) -> float:
        return self.window[1] - self.window[0]

    def launches(self) -> int:
        s, e = self.window
        return sum(1 for ev in self.events if ev.get("ph") == "X" and ev.get("cat") in DEVICE_CATEGORIES
                   and s <= ev["ts"] < e)

    def spans(self, prefix: str) -> list:
        return [ev for ev in self.events if ev.get("ph") == "X" and ev.get("cat") == "user_annotation"
                and ev.get("name", "").startswith(PREFIX + prefix)]

    def op_device_us(self) -> dict:
        """Per op span (by call index): the device µs of every kernel, copy or
        memset launched inside it, joined to its launch by correlation id."""
        launch_at = {}
        for ev in self.events:
            corr = (ev.get("args") or {}).get("correlation")
            if ev.get("ph") == "X" and ev.get("cat") in LAUNCH_CATEGORIES and corr is not None:
                launch_at[corr] = (ev["ts"], ev.get("tid"), ev.get("pid"))
        work = [(launch_at.get((ev.get("args") or {}).get("correlation")), ev.get("dur", 0)) for ev in self.events
                if ev.get("ph") == "X" and ev.get("cat") in DEVICE_CATEGORIES]
        out = {}
        for sp in self.spans("op."):
            idx = int(sp["name"].rpartition("#")[2])
            s, e = sp["ts"], sp["ts"] + sp.get("dur", 0)
            out[idx] = sum(d for at, d in work
                           if at is not None and at[1] == sp.get("tid") and at[2] == sp.get("pid") and s <= at[0] <= e)
        return out

    def top_device_ops(self, n: int = 10) -> list:
        s, e = self.window
        by_name = {}
        for ev in self.events:
            if ev.get("ph") == "X" and ev.get("cat") in DEVICE_CATEGORIES and s <= ev["ts"] < e:
                by_name[ev["name"]] = by_name.get(ev["name"], 0.0) + ev.get("dur", 0) / 1e6
        return [[k[:200], v] for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> list:
        """The longest gaps of the device inside the window, each labelled by the
        innermost benchmark span open on the host at the gap's start."""
        s, e = self.window
        busy = merged(self.device)
        edges = [s] + [x for iv in busy for x in iv] + [e]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges) - 1, 2) if edges[i + 1] > edges[i]]
        spans = [sp for sp in self.spans("") if sp["name"] != PREFIX + "window"]
        out = []
        for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:n]:
            open_ = [sp for sp in spans if sp["ts"] <= a < sp["ts"] + sp.get("dur", 0)]
            label = max(open_, key=lambda sp: sp["ts"])["name"][len(PREFIX):] if open_ else "outside any span"
            out.append([label.split("#")[0], (b - a) / 1e6])
        return out
