"""The readers' arithmetic over the program's own spans and counters.

The port opens a span `rgbdseg.<name>` at each of its layer boundaries while
a profiler runs (`rgbdseg_torch/utils/trace.py`), so in a traced stretch the
spans sit on the clock of the device work. A commit of the port without them
leaves these readers nothing to read: they return None and do not raise.

- `idle_attribution`: every instant of the stretch at which the card runs
  nothing is put down to the latest-started program span open at it on any
  host thread (the rule of `Reading.idle_gaps`, applied to every instant of a
  gap and not only to its start).
- `idle_ms`: the idle time under one span or any span nested in it (on its
  thread, inside its interval), as a share of the stretch's idle time, times
  the idle time per step that `device_idle` implies: the window's wall time
  per step less the stretch's device time per step. The profiler slows the
  host; the share is read from the trace, the size from the window.
  `host.gc` counts for itself alone, wherever it nests, so no instant counts
  twice and the parts sum to at most the whole.
- `device_ms`: the device time per step of the work launched inside a span,
  joined to its launch by the trace's correlation id.
- `map_compute_ms`: the program's counters `map.compute_s` over `map.images`.
"""

from __future__ import annotations

from .trace import DEVICE_CATEGORIES, LAUNCH_CATEGORIES, merged

PREFIX = "rgbdseg."
GC = "host.gc"


def program_spans(reading) -> list:
    """The program's spans in the trace: dicts of name (without the prefix),
    start and end (µs), thread and process."""
    return [{"name": ev["name"][len(PREFIX):], "ts": ev["ts"], "end": ev["ts"] + ev.get("dur", 0),
             "tid": ev.get("tid"), "pid": ev.get("pid")}
            for ev in reading.events if ev.get("ph") == "X" and ev.get("cat") == "user_annotation"
            and ev.get("name", "").startswith(PREFIX)]


def idle_intervals(reading) -> list:
    """(start, end) µs of the stretch in which the card runs nothing."""
    s, e = reading.window
    edges = [s] + [x for iv in merged(reading.device) for x in iv] + [e]
    return [(edges[i], edges[i + 1]) for i in range(0, len(edges) - 1, 2) if edges[i + 1] > edges[i]]


def idle_attribution(reading, spans: list | None = None) -> tuple[dict, float, float]:
    """({index of a span in `spans`: idle µs put down to it}, idle µs under no
    span, the stretch's idle µs). A span gets the idle instants at which it is
    the latest-started span open (of two that start together, the one that
    ends first)."""
    spans = program_spans(reading) if spans is None else spans
    s, e = reading.window
    idle = idle_intervals(reading)
    total = sum(b - a for a, b in idle)
    cuts = sorted({s, e} | {t for sp in spans for t in (sp["ts"], sp["end"]) if s < t < e})
    starts = sorted(range(len(spans)), key=lambda i: spans[i]["ts"])
    out, unlabelled = {}, 0.0
    open_, nxt, g = set(), 0, 0
    for a, b in zip(cuts, cuts[1:]):
        while nxt < len(starts) and spans[starts[nxt]]["ts"] <= a:
            open_.add(starts[nxt])
            nxt += 1
        open_ = {i for i in open_ if spans[i]["end"] > a}
        while g < len(idle) and idle[g][1] <= a:
            g += 1
        part, k = 0.0, g
        while k < len(idle) and idle[k][0] < b:
            part += min(b, idle[k][1]) - max(a, idle[k][0])
            k += 1
        if part <= 0:
            continue
        if open_:
            label = max(open_, key=lambda i: (spans[i]["ts"], -spans[i]["end"]))
            out[label] = out.get(label, 0.0) + part
        else:
            unlabelled += part
    return out, unlabelled, total


def nested_in(inner: dict, outer: dict) -> bool:
    return (inner["tid"], inner["pid"]) == (outer["tid"], outer["pid"]) and \
        outer["ts"] <= inner["ts"] and inner["end"] <= outer["end"]


def idle_per_step_us(reading) -> float:
    """The idle µs per step that `device_idle` implies: the window's wall time
    per step less the stretch's device time per step."""
    return reading.step_s * 1e6 - reading.busy_us() / reading.steps


def idle_ms(run, name: str) -> float | None:
    """ms per step of the card's idle time under span `name` (§ module doc);
    None where the trace holds no program span or no idle time."""
    reading = run.reading
    if reading is None:
        return None
    spans = program_spans(reading)
    per_step = idle_per_step_us(reading)
    if not spans or per_step <= 0:
        return None
    attributed, _, total = idle_attribution(reading, spans)
    if total <= 0:
        return None
    owners = [sp for sp in spans if sp["name"] == name]
    under = 0.0
    for i, us in attributed.items():
        sp = spans[i]
        if sp["name"] == name or (name != GC and sp["name"] != GC and any(nested_in(sp, o) for o in owners)):
            under += us
    return under / total * per_step / 1e3


def device_ms(run, name: str) -> float | None:
    """ms per step of device work (kernels, copies, memsets) launched on the
    host inside span `name`; None where the trace holds no such span."""
    reading = run.reading
    if reading is None:
        return None
    owners = [sp for sp in program_spans(reading) if sp["name"] == name]
    if not owners:
        return None
    launch_at = {}
    for ev in reading.events:
        corr = (ev.get("args") or {}).get("correlation")
        if ev.get("ph") == "X" and ev.get("cat") in LAUNCH_CATEGORIES and corr is not None:
            launch_at[corr] = (ev["ts"], ev.get("tid"), ev.get("pid"))
    total = 0.0
    for ev in reading.events:
        if ev.get("ph") == "X" and ev.get("cat") in DEVICE_CATEGORIES:
            at = launch_at.get((ev.get("args") or {}).get("correlation"))
            if at is not None and any((at[1], at[2]) == (o["tid"], o["pid"]) and o["ts"] <= at[0] <= o["end"]
                                      for o in owners):
                total += ev.get("dur", 0)
    return total / reading.steps / 1e3


def map_compute_ms(run) -> float | None:
    """Host ms per image scored of the mAP's `compute`, over every `evaluate`
    call of the run (the program's cumulative counters); None where the
    program keeps no such counters or scored no image."""
    try:
        from rgbdseg_torch.utils.trace import COUNTERS
    except ImportError:
        return None
    counts = COUNTERS.get("map") or {}
    if not counts.get("images"):
        return None
    return 1e3 * counts["compute_s"] / counts["images"]
