"""The port's tracer (`rgbdseg_torch/utils/trace.py`) on the CPU at a tiny size:
the spans that the train step, the bf16 train step and `evaluate` open under a
profiler, and their nesting; one kernel span per wrapper call; no profiler call
of the program's without a profiler; the same outputs with and without one;
the counters."""

import copy
import gc

import numpy as np
import pytest
import torch

from rgbdseg_torch.config import ModelConfig, PreprocessConfig
from rgbdseg_torch.data.pipeline import Batch
from rgbdseg_torch.models.mask2former import Mask2FormerRGBD
from rgbdseg_torch.ops import kernels
from rgbdseg_torch.ops.kernels import deformable, masked_attention, point_sample
from rgbdseg_torch.train import evaluator as E
from rgbdseg_torch.train import trainer as T
from rgbdseg_torch.train.arguments import TrainingArguments
from rgbdseg_torch.utils import trace
from rgbdseg_torch.utils.weights import init_weights

HW = (64, 96)
PP = PreprocessConfig(height=HW[0], width=HW[1])
ID2LABEL = {i: f"class{i}" for i in range(5)}


def _cfg():
    return ModelConfig.tiny(num_labels=5, version="0.4.0").replace(num_queries=20, train_num_points=64)


def _batches(seed: int, n: int, b: int = 2, slots: int = 12) -> list:
    """Host batches of raw uint8 RGB-D frames (built into the stack on the
    device) and 5-7 rectangle instances each, the masks also bit-packed."""
    rng = np.random.default_rng(seed)
    h, w = HW
    out = []
    for _ in range(n):
        frames = rng.integers(0, 256, (b, h, w, 6), dtype=np.uint8)
        frames[..., 4:] = frames[..., 3:4]  # the depth as RGB, as its PNG reads
        masks = np.zeros((b, slots, h, w), np.float32)
        for i in range(b):
            for k in range(int(rng.integers(5, 8))):
                y, x = int(rng.integers(0, h - 16)), int(rng.integers(0, w - 16))
                masks[i, k, y:y + int(rng.integers(8, 16)), x:x + int(rng.integers(8, 16))] = 1
        valid = masks.any(axis=(2, 3))
        packed = np.packbits(masks.astype(bool).reshape(b, slots, -1), axis=-1)
        out.append(Batch(frames, masks, rng.integers(0, 5, (b, slots)).astype(np.int64), valid,
                         mask_labels_packed=packed))
    return out


@pytest.fixture(scope="module")
def setup():
    torch.manual_seed(0)
    model = init_weights(Mask2FormerRGBD(_cfg()), 3).train()
    return model, _batches(11, 3)


def _args(bf16: bool) -> TrainingArguments:
    return TrainingArguments(per_device_train_batch_size=2, learning_rate=1e-4, bf16=bf16, num_train_epochs=10,
                             instance_bucket_floor=8)


def _train(model, batch, bf16: bool):
    """One train step from a copy of `model`: (loss, grad norm, parameters after)."""
    model = copy.deepcopy(model)
    args = _args(bf16)
    opt = T.make_optimizer(model, args, 100)
    gen = torch.Generator().manual_seed(5)
    loss, _, gnorm = T.train_step(model, opt, T.put_batch(batch, args, "cpu"), gen, PP)
    return loss, gnorm, {n: p.detach().clone() for n, p in model.named_parameters()}


def _evaluate(model, batches):
    return T.evaluate(copy.deepcopy(model), batches, ID2LABEL, PP, generator=torch.Generator().manual_seed(0))


def _profiled(fn):
    """(fn's result, the program's spans as (name, start, end, thread)) under a CPU profiler."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        result = fn()
    spans = [(e.name[len(trace.PREFIX):], e.time_range.start, e.time_range.end, e.thread)
             for e in prof.events() if e.name.startswith(trace.PREFIX)]
    return result, spans


def _names(spans) -> list:
    return [s[0] for s in spans]


def _inside(spans, inner: str, outer: str) -> bool:
    """Every `inner` span lies in an `outer` span on its thread."""
    outs = [s for s in spans if s[0] == outer]
    return all(any(o[3] == s[3] and o[1] <= s[1] and s[2] <= o[2] for o in outs) for s in spans if s[0] == inner)


def _counting(monkeypatch, module, attr: str) -> dict:
    """Count the calls of `module.attr` (a kernel's plain version, which its wrapper calls once per call here)."""
    seen = {"n": 0}
    fn = getattr(module, attr)

    def counted(*args, **kwargs):
        seen["n"] += 1
        return fn(*args, **kwargs)

    monkeypatch.setattr(module, attr, counted)
    return seen


TRAIN_NESTING = [("upload", "train.put_batch"), ("train.micro_step", "train.step"), ("apply_step", "train.step"),
                 ("channel_stack", "train.micro_step"), ("forward", "train.micro_step"),
                 ("model.backbone", "forward"), ("model.fusion", "forward"), ("model.pixel_decoder", "forward"),
                 ("model.decoder", "forward"), ("criterion", "train.micro_step"), ("matcher", "criterion"),
                 ("matcher.copy", "matcher"), ("matcher.solve", "matcher"), ("backward", "train.micro_step"),
                 ("op.k1", "model.pixel_decoder"), ("op.k3", "model.decoder"), ("op.ps", "criterion"),
                 ("op.k1_bwd", "backward")]


@pytest.mark.parametrize("bf16", [False, True])
def test_train_step_spans_and_nesting(setup, monkeypatch, bf16):
    model, batches = setup
    calls = {"k1": _counting(monkeypatch, deformable, "deform_sample_levels_plain"),
             "k1_bwd": _counting(monkeypatch, deformable, "deform_sample_levels_plain_bwd"),
             "k3": _counting(monkeypatch, masked_attention, "masked_cross_attention_plain"),
             "ps": _counting(monkeypatch, point_sample, "point_sample_plain")}

    def step():
        args = _args(bf16)
        net = copy.deepcopy(model)
        opt = T.make_optimizer(net, args, 100)
        return T.train_step(net, opt, T.put_batch(batches[0], args, "cpu"), torch.Generator().manual_seed(5), PP)

    _, spans = _profiled(step)
    names = _names(spans)
    for name in ("train.put_batch", "upload", "train.step", "train.micro_step", "channel_stack", "forward",
                 "model.backbone", "model.fusion", "model.pixel_decoder", "model.decoder", "criterion", "matcher",
                 "matcher.copy", "matcher.solve", "backward", "apply_step"):
        assert names.count(name) == 1, (name, names.count(name))
    assert names.count("forward.cast") == (1 if bf16 else 0)
    if bf16:
        assert _inside(spans, "forward.cast", "forward")
    for inner, outer in TRAIN_NESTING:
        assert _inside(spans, inner, outer), (inner, outer)
    for op, seen in calls.items():
        assert seen["n"] > 0 and names.count(f"op.{op}") == seen["n"], (op, seen["n"], names.count(f"op.{op}"))


def test_evaluate_spans_and_nesting(setup, monkeypatch):
    model, batches = setup
    calls = {"k1": _counting(monkeypatch, deformable, "deform_sample_levels_plain"),
             "k3": _counting(monkeypatch, masked_attention, "masked_cross_attention_plain"),
             "ps": _counting(monkeypatch, point_sample, "point_sample_plain")}
    _, spans = _profiled(lambda: _evaluate(model, batches))
    names = _names(spans)
    n = len(batches)
    for name in ("eval.batch", "eval.inputs", "upload", "channel_stack", "forward", "criterion", "matcher",
                 "eval.update"):
        assert names.count(name) == n, (name, names.count(name))
    assert names.count("eval.drain") == n and names.count("eval.compute") == 1 and names.count("eval.flush") >= 1
    for inner, outer in [("eval.inputs", "eval.batch"), ("upload", "eval.inputs"), ("channel_stack", "eval.inputs"),
                         ("forward", "eval.batch"), ("criterion", "eval.batch"), ("model.fusion", "forward")]:
        assert _inside(spans, inner, outer), (inner, outer)
    drains = [s for s in spans if s[0] == "eval.drain"]
    around = [s for s in spans if s[0] in ("eval.update", "eval.flush")]
    assert all(any(o[1] <= d[1] and d[2] <= o[2] for o in around) for d in drains)
    for op, seen in calls.items():
        assert names.count(f"op.{op}") == seen["n"] > 0


def test_gc_pass_is_a_span_only_under_a_profiler():
    _, spans = _profiled(gc.collect)
    assert "host.gc" in _names(spans)
    entered = []
    real = torch.ops.profiler._record_function_enter_new
    try:
        torch.ops.profiler._record_function_enter_new = lambda name, *a: entered.append(name) or real(name, *a)
        gc.collect()
    finally:
        torch.ops.profiler._record_function_enter_new = real
    assert entered == []


def test_no_profiler_call_of_the_program_without_a_profiler(setup, monkeypatch):
    """Without a profiler the program enters no `record_function`. (torch's own
    `Optimizer.step` and `zero_grad` enter one each, named "Optimizer.<method>#...",
    whatever runs: they are not the program's, so only its names must be absent.)"""
    model, batches = setup
    entered = []
    real = torch.ops.profiler._record_function_enter_new

    def counting(name, *args):
        entered.append(name)
        return real(name, *args)

    monkeypatch.setattr(torch.ops.profiler, "_record_function_enter_new", counting)
    assert not torch.autograd._profiler_enabled()
    _train(model, batches[0], bf16=False)
    _train(model, batches[0], bf16=True)
    _evaluate(model, batches)
    gc.collect()
    assert [n for n in entered if n.startswith(trace.PREFIX)] == []
    assert all(n.startswith("Optimizer.") for n in entered)


@pytest.mark.parametrize("bf16", [False, True])
def test_train_step_outputs_equal_with_and_without_profiler(setup, bf16):
    model, batches = setup
    plain = _train(model, batches[1], bf16)
    traced, spans = _profiled(lambda: _train(model, batches[1], bf16))
    assert spans
    assert torch.equal(plain[0], traced[0]) and torch.equal(plain[1], traced[1])
    assert all(torch.equal(plain[2][n], traced[2][n]) for n in plain[2])


def test_evaluate_outputs_equal_with_and_without_profiler_and_map_counters(setup):
    model, batches = setup
    before = dict(E.MAP)
    plain = _evaluate(model, batches)
    after_one = dict(E.MAP)
    traced, spans = _profiled(lambda: _evaluate(model, batches))
    assert spans
    drop = ("eval_runtime", "eval_samples_per_second")
    assert {k: v for k, v in plain.items() if k not in drop} == {k: v for k, v in traced.items() if k not in drop}
    images = sum(b.pixel_values.shape[0] for b in batches)
    assert after_one["images"] - before["images"] == images
    assert E.MAP["images"] - after_one["images"] == images
    assert after_one["compute_s"] > before["compute_s"]


def test_evaluate_counts_only_the_images_it_scores(setup):
    model, batches = setup
    before = E.MAP["images"]
    T.evaluate(copy.deepcopy(model), batches, ID2LABEL, PP, num_examples=3)
    assert E.MAP["images"] - before == 3


def test_counters_are_one_registry():
    assert trace.COUNTERS["kernels.LAUNCHES"] is kernels.LAUNCHES
    assert trace.COUNTERS["kernels.FLOPS"] is kernels.FLOPS
    assert trace.COUNTERS["map"] is E.MAP and set(E.MAP) == {"compute_s", "images"}
    assert trace.counters("map") is E.MAP
    assert set(kernels.LAUNCHES) == set(kernels.FLOPS) == set(kernels._SIGNATURES)


def test_span_is_a_decorator_and_a_context():
    @trace.span("test.outer")
    def outer(x):
        with trace.span("test.inner"):
            return x + 1

    assert outer.__name__ == "outer" and outer(1) == 2
    result, spans = _profiled(lambda: outer(2))
    assert result == 3 and _names(spans) == ["test.outer", "test.inner"]
    assert _inside(spans, "test.inner", "test.outer")
