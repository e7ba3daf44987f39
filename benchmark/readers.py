"""The arithmetic the per-layer metrics' readers (`metrics/<name>.py`) share.
Each takes the traced run (`harness.Run`) and returns a number, or None where
the run holds nothing to read."""

from __future__ import annotations

from . import harness, peaks


def mfu(run) -> float | None:
    """% of the card's dense peak for the cell's precision: the reference's
    FLOPs per step (or batch) over the wall seconds per step of the window
    outside the traced stretch."""
    p = harness.peaks_of(run)
    if p is None or not run.flops_per_step or run.reading is None:
        return None
    rate = run.flops_per_step / run.reading.step_s
    return 100.0 * rate / p["mfu"]["bfloat16" if run.cell.traffic["bf16"] else "float32"]


def roofline(run, ops) -> float | None:
    """% of the roofline over the calls of the named ops in the traced
    stretch: the sum of their bounds over the sum of their device time."""
    p = harness.peaks_of(run)
    if p is None or run.reading is None:
        return None
    modules = harness.roofline_ops()
    measured = run.reading.op_device_us()
    bound = spent = 0.0
    for call in run.reading.calls:
        if call.op in ops and measured.get(call.index):
            bound += peaks.bound_s(*modules[call.op].cost(call.record), p)
            spent += measured[call.index] / 1e6
    return 100.0 * bound / spent if spent > 0 else None


def idle(run) -> float | None:
    """% of a step's wall time in which no work runs on the card: the device
    time per step of the traced stretch (the union of its device intervals)
    against the wall time per step of the window outside it (the profiler
    slows the host, not the card)."""
    if run.reading is None or run.reading.step_s <= 0:
        return None
    return 100.0 * (1.0 - run.reading.busy_us() / 1e6 / run.reading.steps / run.reading.step_s)


def launches(run) -> float | None:
    """Kernels, copies and memsets on the card per step (or batch) of the traced stretch."""
    if run.reading is None:
        return None
    return run.reading.launches() / run.reading.steps
