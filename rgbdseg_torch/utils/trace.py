"""The port's tracer: spans at its layer boundaries, and its counters.

`span(name)` is a context manager and a decorator. While a torch profiler is
running (`torch.autograd._profiler_enabled()`) it opens
`torch.profiler.record_function("rgbdseg." + name)`, so the span lies on the
profiler's clock, the clock of the CUDA work in the same trace; otherwise it
enters no profiler call and costs one check. Any profiler sees the spans: the
benchmark's traced stretch and `Trainer`'s `profile_start_step` trace alike.
A span opened in an autograd Function's `backward` runs on the autograd
engine's thread. Python's cyclic garbage collector gets a span of its own,
`host.gc`, around each pass (from `gc.callbacks`), under the same condition.

The spans, by layer (nested ones indented):

    train.put_batch         trainer.put_batch
      upload                  its host-to-device copies
    train.step              trainer.train_step
      train.micro_step        trainer.micro_step
        channel_stack           data.device_preprocess.build_from_packed
        forward                 trainer.forward
          forward.cast            the bf16 policy's copies of parameters and pixels
          model.backbone          the Swin encoder(s)
          model.fusion            ratio predictor, DSAM / E-DSAM, DGGM, feature fuser
          model.pixel_decoder     the deformable pixel decoder
          model.decoder           the masked-attention transformer decoder
        criterion               ops.losses.mask2former_loss
          matcher                 ops.matcher.hungarian_batch
            matcher.copy            the cost matrices' device-to-host copy (waits on the device)
            matcher.solve           the assignments on the host
        backward                the loss's .backward()
      apply_step              trainer.apply_step (clip and AdamW)
    eval.batch              one batch of trainer.evaluate
      eval.inputs             its upload and channel stack
        upload
      eval.update             train.evaluator.Evaluator.update
        eval.drain              a deferred batch's event wait and numpy
    eval.flush              Evaluator.flush
    eval.compute            Evaluator.compute (the mAP on the host)
    op.k1, op.k3, op.ps     each hand kernel wrapper's call
    op.k1_bwd, op.k3_bwd, op.ps_bwd   its backward, on the autograd thread
    host.gc                 a pass of Python's cyclic garbage collector

`COUNTERS` is the registry of the port's counters: named groups of
cumulative numbers, each a plain dict that its owner updates in place and that
`counters(name, keys)` creates. `kernels.LAUNCHES` and `kernels.FLOPS` are the
hand kernels' launches and operations per entry point (`ops/kernels`); `map`
holds `compute_s` and `images`, the host seconds of `Evaluator.compute` and
the images it scored.
"""

from __future__ import annotations

import functools
import gc

import torch

PREFIX = "rgbdseg."

COUNTERS: dict[str, dict] = {}


def counters(name: str, keys=()) -> dict:
    """The registry's counter group `name`, created at the first call; each of
    `keys` starts at 0."""
    group = COUNTERS.setdefault(name, {})
    for key in keys:
        group.setdefault(key, 0)
    return group


_profiling = torch.autograd._profiler_enabled


class span:
    """`with span(name):` or `@span(name)`: a `record_function` named
    "rgbdseg.<name>" while a profiler is running, nothing otherwise."""

    __slots__ = ("name", "_open")

    def __init__(self, name: str):
        self.name = name
        self._open = None

    def __enter__(self):
        if _profiling():
            self._open = torch.profiler.record_function(PREFIX + self.name)
            self._open.__enter__()
        return self

    def __exit__(self, *exc):
        if self._open is not None:
            self._open.__exit__(*exc)
            self._open = None
        return False

    def __call__(self, fn):
        name = self.name

        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)

        return spanned


_gc_open: list = []


def _gc_span(phase: str, info: dict) -> None:
    """`gc.callbacks` entry: a `host.gc` span around each collection while a
    profiler is running. A collection runs to its end on one thread."""
    if phase == "start":
        if _profiling():
            rf = torch.profiler.record_function(PREFIX + "host.gc")
            rf.__enter__()
            _gc_open.append(rf)
    elif _gc_open:
        _gc_open.pop().__exit__(None, None, None)


if _gc_span not in gc.callbacks:
    gc.callbacks.append(_gc_span)
