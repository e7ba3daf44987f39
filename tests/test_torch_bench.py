"""The port's bench entry (`bench_torch.py`) against `bench.py`, on the CPU at
tiny size (`ModelConfig.tiny`, 64x64).

- The train step of `_build_train_state` against bench.py's (optax.adamw(1e-4),
  the forward under the bf16 policy or in float32) on the JAX weights through
  `from_flax`, one step on the same numpy batch, dropout off on both sides and
  the criterion's points injected as `tests/test_torch_train.py` injects them.
  float32: loss within 1e-5 relative, the updated parameters within 1e-5 (see
  the test for the elements whose gradient is rounding noise) and the
  BatchNorm running statistics within 1e-5 (`tests/test_torch_train.py`'s and
  `tests/test_torch_train_full.py`'s step tolerances). bf16: the bf16
  policy's bound of `tests/test_torch_train_full.py`, the loss within 1e-2
  relative of bench.py's bf16 step and nearer to it than that step is to its
  own float32 one.
- The serving model (every float parameter and buffer cast to bfloat16,
  bfloat16 pixels) against the JAX model applied under bench.py's cast of the
  whole variable tree: class and mask logits within 0.2 of the JAX forward's
  largest |logit| (the port's bf16 eval bound, `tests/test_torch_train_full.py`;
  measured 0.024 and 0.105), and less than half as far from it as it is from
  the float32 forward (measured 0.093 and 0.249 away). As in that file's eval
  test, the JAX package folds each BatchNorm into the convolution before it
  and rounds the folded kernel to bfloat16, where the port normalises the
  convolution's bfloat16 output in float32; E-DSAM's ratio then moves DSAM's
  window edges. No tighter bound holds on this reading.
- `_mfu_fields` gives bench.py's `tflops_per_sec` on the same inputs; the
  H100's name finds the SXM peaks by the longest prefix; an unknown card gets
  no `mfu`.
- `interval_union` against a brute-force union of random intervals.
- Each mode on the CPU returns bench.py's keys for that mode (those of a run
  without a device trace and without a known card), every value finite; `all`
  merges the train and eval keys into the inference line and prints one line.
"""

import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

import bench_torch
from rgbdseg_tpu.config import ModelConfig as JConfig
from rgbdseg_tpu.models.mask2former import Mask2FormerRGBD as JModel
from rgbdseg_tpu.ops import losses as jlosses
from rgbdseg_torch.config import ModelConfig
from rgbdseg_torch.models.mask2former import Mask2FormerRGBD
from rgbdseg_torch.ops import losses as tlosses
from rgbdseg_torch.ops.kernels import LAUNCHES, reset_launches
from rgbdseg_torch.utils.weights import from_flax, to_flax
from test_torch_train import _coords, _flat

HW = 64
NUM_LABELS = 3


@pytest.fixture(scope="module")
def jbench(tmp_path_factory):
    """bench.py, imported with JAX_CACHE_DIR in a temporary directory; the
    suite's compilation-cache settings, which its import changes, are put back
    at once (the import compiles nothing)."""
    keys = ("jax_compilation_cache_dir", "jax_persistent_cache_min_compile_time_secs")
    before = {k: getattr(jax.config, k) for k in keys}
    old_env = os.environ.get("JAX_CACHE_DIR")
    os.environ["JAX_CACHE_DIR"] = str(tmp_path_factory.mktemp("jax_cache"))
    try:
        import bench
    finally:
        if old_env is None:
            os.environ.pop("JAX_CACHE_DIR")
        else:
            os.environ["JAX_CACHE_DIR"] = old_env
        for k, v in before.items():
            jax.config.update(k, v)
    return bench


@pytest.fixture
def same_points(monkeypatch):
    monkeypatch.setattr(jlosses, "_uniform", lambda rng, shape: jnp.asarray(_coords(shape)))
    monkeypatch.setattr(tlosses, "_uniform", lambda generator, shape: torch.from_numpy(_coords(shape)))
    monkeypatch.setattr(fnn.Dropout, "__call__", lambda self, x, *a, **k: x)


def _train_batch(seed: int = 0, t: int = 8):
    rng = np.random.RandomState(seed)
    px = rng.rand(1, HW, HW, 10).astype(np.float32)
    masks = (rng.rand(1, t, HW, HW) > 0.7).astype(np.float32)
    classes = rng.randint(0, NUM_LABELS, (1, t)).astype(np.int32)
    return px, masks, classes, np.ones((1, t), bool)


_JAX_STEPS = {}


def _jax_step(jbench, bf16: bool):
    """bench.py's state (its own seeded init) and one jitted step on `_train_batch`:
    (params, batch_stats before, loss, params and batch_stats after)."""
    if bf16 not in _JAX_STEPS:
        cfg = JConfig.tiny(num_labels=NUM_LABELS, version="0.4.0")
        step, params, opt_state, stats = jbench._build_train_state(cfg, HW, HW, bf16=bf16)
        params, stats = jax.device_get((params, stats))
        new_p, _, new_s, loss = jax.jit(step)(params, opt_state, stats, *map(jnp.asarray, _train_batch()))
        _JAX_STEPS[bf16] = (params, stats, float(loss), jax.device_get(new_p), jax.device_get(new_s))
    return _JAX_STEPS[bf16]


def _port_step(params, stats, bf16: bool):
    """The port's `_build_train_state` on the JAX weights, one step on `_train_batch`:
    (loss, parameters and running statistics after, in flax's layout)."""
    step, model, opt = bench_torch._build_train_state(ModelConfig.tiny(num_labels=NUM_LABELS, version="0.4.0"),
                                                      HW, HW, bf16, device="cpu")
    model.load_state_dict(from_flax(params, stats), strict=True)
    ratio = model.pixel_level_module.ratio_predictor
    ratio.dropout0.p = ratio.dropout1.p = 0.0
    reset_launches()
    loss = step(*(torch.from_numpy(a) for a in _train_batch()))
    assert set(LAUNCHES.values()) == {0}
    assert opt.count == 1 and all(g["weight_decay"] == 1e-4 for g in opt.param_groups)
    new_p, new_s = to_flax({n: t.detach() for n, t in model.state_dict().items()})
    return loss.item(), _flat(new_p), _flat(new_s)


def test_train_step_matches_bench_py_float32(jbench, same_points):
    """Adam's first step moves a parameter by lr x g / (|g| + eps) + lr x wd x p:
    where |g| is within a hundred eps (1e-6) of 0 it divides rounding noise by
    about eps. So: every element whose update in bench.py's step fixes its
    gradient's sign (|g| >= 99 eps) within 1e-5 (measured 5.9e-8); the others
    within 1e-5 at all but 1e-5 of the model's elements (measured 10 of 5.0M);
    the attention key biases, whose exact gradient is 0 (softmax ignores a
    per-query constant, `tests/test_torch_train.py`), hold noise only."""
    params, stats, j_loss, j_params, j_stats = _jax_step(jbench, bf16=False)
    loss, got_p, got_s = _port_step(params, stats, bf16=False)
    np.testing.assert_allclose(loss, j_loss, rtol=1e-5)
    ref, before = _flat(j_params), _flat(params)
    assert set(ref) <= set(got_p)
    lr = wd = 1e-4
    worst, loose, total = 0.0, 0, 0
    for k in ref:
        total += ref[k].size
        if k.endswith("k_proj/bias"):
            continue
        err = np.abs(got_p[k] - ref[k])
        sure = np.abs(-(ref[k] - before[k]) / lr - wd * before[k]) >= 0.99
        if sure.any():
            worst = max(worst, float(err[sure].max()))
        loose += int((err[~sure] > 1e-5).sum())
    assert worst <= 1e-5 and loose <= 1e-5 * total, (worst, loose, total)
    for k, r in _flat(j_stats).items():
        np.testing.assert_allclose(got_s[k], r, atol=1e-5, rtol=1e-5, err_msg=k)


def test_train_step_matches_bench_py_bf16(jbench, same_points):
    params, stats, j_bf16, _, _ = _jax_step(jbench, bf16=True)
    _, _, j_f32, _, _ = _jax_step(jbench, bf16=False)
    loss, got_p, _ = _port_step(params, stats, bf16=True)
    gap = abs(loss - j_bf16) / abs(j_bf16)
    assert gap <= 1e-2, gap
    assert gap < abs(j_bf16 - j_f32) / abs(j_f32), (gap, j_bf16, j_f32)
    assert all(np.isfinite(v).all() and v.dtype == np.float32 for v in got_p.values())


def test_bf16_serving_forward_matches_jax_under_bench_cast(jbench):
    """bench.py's `jax.tree.map(astype(bfloat16))` over params and batch_stats
    and bfloat16 pixels, against `bench_torch.serving_model` of the same weights."""
    cfg = JConfig.tiny(num_labels=NUM_LABELS, version="0.4.0")
    params, stats = _jax_step(jbench, bf16=False)[:2]  # bench.py's seeded init
    v = {"params": params, "batch_stats": stats}
    x = np.random.RandomState(5).rand(2, HW, HW, 10).astype(np.float32)
    apply = jax.jit(lambda v, x: JModel(cfg).apply(v, x, deterministic=True))
    cast = lambda t: jax.tree.map(lambda a: a.astype(jnp.bfloat16) if a.dtype == jnp.float32 else a, t)
    outs = {}
    for bf16 in (False, True):
        o = apply(cast(v) if bf16 else v, jnp.asarray(x, jnp.bfloat16 if bf16 else jnp.float32))
        outs[bf16] = [np.asarray(o.class_queries_logits, np.float32), np.asarray(o.masks_queries_logits, np.float32)]
    model = Mask2FormerRGBD(ModelConfig.tiny(num_labels=NUM_LABELS, version="0.4.0"))
    model.load_state_dict(from_flax(v["params"], v["batch_stats"]), strict=True)
    model = bench_torch.serving_model(model, torch.bfloat16)
    assert {t.dtype for t in model.state_dict().values()} == {torch.bfloat16, torch.int64}
    got = bench_torch._forward(model)(torch.from_numpy(x).to(torch.bfloat16))
    assert all(g.dtype == torch.bfloat16 for g in got)
    for g, ref, f32 in zip(got, outs[True], outs[False]):
        scale = np.abs(ref).max()
        err = np.abs(g.float().numpy() - ref).max() / scale
        assert err <= 0.2 and err < 0.5 * np.abs(ref - f32).max() / scale, err


@pytest.mark.parametrize("flops,ips,batch", [(3.2e12, 11.9, 1), (7.7e11, 52.0, 4), (1.0, 1e-3, 2), (0.0, 5.0, 1)])
def test_mfu_fields_match_bench_py(jbench, flops, ips, batch):
    """The same inputs give bench.py's fields on a device neither table knows
    (here the CPU: JAX's device kind "cpu", the port's device type)."""
    assert jax.devices()[0].device_kind == "cpu"
    assert bench_torch._mfu_fields(flops, ips, batch, "cpu") == jbench._mfu_fields(flops, ips, batch)


def test_mfu_peaks_by_longest_prefix(monkeypatch):
    f = bench_torch._mfu_fields
    sxm = "NVIDIA H100 80GB HBM3"
    assert f(989.4e12, 1.0, 1, sxm) == {"tflops_per_sec": 989.4, "mfu": 1.0, "device_kind": sxm}
    assert f(66.9e12 / 2, 2.0, 2, sxm, "float32")["mfu"] == 0.5
    assert f(1e12, 10.0, 1, sxm)["mfu"] == round(10e12 / 989.4e12, 4)
    for unknown in ("NVIDIA A100-SXM4-80GB", "NVIDIA H100 PCIe", "cpu"):
        assert f(1e12, 10.0, 1, unknown) == {"tflops_per_sec": 10.0}
    monkeypatch.setitem(bench_torch.PEAK_FLOPS, "NVIDIA H100", {"bfloat16": 1.0})
    assert f(1e12, 10.0, 1, sxm)["mfu"] == round(10e12 / 989.4e12, 4)  # the longer prefix wins
    assert f(1e12, 10.0, 1, "NVIDIA H100 PCIe")["mfu"] == 1e13


def test_interval_union_matches_brute_force():
    rng = np.random.RandomState(0)
    for n in (0, 1, 2, 5, 40, 200):
        starts = rng.randint(0, 500, n)
        ends = starts + rng.randint(0, 60, n)
        covered = np.zeros(600, bool)
        for s, e in zip(starts, ends):
            covered[s:e] = True
        pairs = [(float(s), float(e)) for s, e in zip(starts, ends)]
        assert bench_torch.interval_union(pairs) == covered.sum()
        assert bench_torch.interval_union(pairs[::-1]) == covered.sum()


def test_device_intervals_take_kernels_copies_and_memsets_only():
    events = [
        {"ph": "X", "cat": "kernel", "ts": 10.0, "dur": 5.0},
        {"ph": "X", "cat": "gpu_memcpy", "ts": 12.0, "dur": 10.0},
        {"ph": "X", "cat": "gpu_memset", "ts": 30.0, "dur": 1.0},
        {"ph": "X", "cat": "gpu_user_annotation", "ts": 0.0, "dur": 100.0},
        {"ph": "X", "cat": "cpu_op", "ts": 0.0, "dur": 100.0},
        {"ph": "i", "cat": "kernel", "ts": 50.0},
    ]
    pairs = bench_torch.device_intervals(events)
    assert pairs == [(10.0, 15.0), (12.0, 22.0), (30.0, 31.0)]
    assert bench_torch.interval_union(pairs) == 13.0


# bench.py's keys per mode on a run with no device trace and no known card (the
# CPU); the train bench adds its instance counts when (T, T_valid) != (16, 16).
KEYS = {
    "infer": {"metric", "value", "unit", "vs_baseline", "tflops_per_sec", "wall_ms_per_image", "chunk_ms_per_image"},
    "train": {"metric", "value", "unit", "vs_baseline", "tflops_per_sec", "wall_ms_per_step", "max_instances",
              "real_instances", "step_instances"},
    "eval": {"metric", "value", "unit", "vs_baseline", "metric_compute_s"},
    "pipeline": {"metric", "value", "unit", "vs_baseline", "pipeline_cold_img_s", "pipeline_cached_img_s",
                 "upload_bound_img_s", "device_channels", "host_cores"},
}


@pytest.mark.parametrize("mode", sorted(KEYS))
def test_each_mode_returns_bench_py_keys(mode, tmp_path, monkeypatch):
    monkeypatch.setenv("BENCH_T", "8")  # the tiny model has 10 queries
    monkeypatch.setenv("BENCH_DISK_N", "2")
    monkeypatch.setenv("BENCH_DISK_ROOT", str(tmp_path / "disk"))
    bench = getattr(bench_torch, f"bench_{mode}")
    reset_launches()
    r = bench(cfg=ModelConfig.tiny(num_labels=NUM_LABELS, version="0.4.0"), h=HW, w=HW, iters=2, batch=2,
              device="cpu")
    assert set(LAUNCHES.values()) == {0}
    assert set(r) == KEYS[mode]
    assert r["unit"] == "images/sec" and r["metric"].startswith("NYUv2 640x480")
    for k, v in r.items():
        if k not in ("metric", "unit"):
            assert all(math.isfinite(x) and x >= 0 for x in (v if isinstance(v, list) else [v])), (k, v)
    assert r["value"] > 0


def test_main_all_merges_one_line(monkeypatch, capsys):
    """BENCH_MODE=all: the train and eval keys on the inference line, one line printed."""
    fake = {
        "bench_infer": {"metric": "i", "value": 3.0, "mfu": 0.1},
        "bench_train": {"value": 2.0, "vs_baseline": 2.06, "mfu": 0.05, "device_ms_per_step": 9.5},
        "bench_eval": {"value": 7.0, "vs_baseline": 11.48, "metric_compute_s": 0.5},
    }
    for name, res in fake.items():
        monkeypatch.setattr(bench_torch, name, lambda device=None, res=res: dict(res))
    monkeypatch.setenv("BENCH_MODE", "all")
    r = bench_torch.main([], device="cpu")
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1 and json.loads(lines[0]) == r
    assert r == {"metric": "i", "value": 3.0, "mfu": 0.1, "train_images_per_sec": 2.0, "train_vs_baseline": 2.06,
                 "train_mfu": 0.05, "train_device_ms_per_step": 9.5, "eval_images_per_sec": 7.0,
                 "eval_vs_baseline": 11.48, "eval_metric_compute_s": 0.5}
    monkeypatch.setenv("BENCH_MODE", "nonsense")
    with pytest.raises(SystemExit):
        bench_torch.main(["--device", "cpu"])
