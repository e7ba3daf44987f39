#!/usr/bin/env python
"""Benchmark of the PyTorch port (the counterpart of `bench.py`): NYUv2-shaped
640x480 RGB-D throughput of version 0.4.0 on one CUDA card.

    python bench_torch.py [--device cpu]

Runs the flagship model (Swin-T + E-DSAM + DGGM + deformable pixel decoder +
masked-attention decoder) at full width with seeded random weights and prints
ONE JSON line. The default (BENCH_MODE=all) carries inference images/s with
MFU, the full train step's images/s and MFU, and end-to-end eval images/s:
{"metric": ..., "value": N, "unit": "images/sec", "vs_baseline": N,
 "tflops_per_sec": ..., "mfu": ..., "device_kind": ..., "wall_ms_per_image": ...,
 "chunk_ms_per_image": [...], "device_ms_per_image": ..., "train_images_per_sec": ...,
 "train_vs_baseline": ..., "train_mfu": ..., "train_device_ms_per_step": ...,
 "eval_images_per_sec": ..., "eval_vs_baseline": ..., "eval_metric_compute_s": ...}
BENCH_MODE=infer|train|eval|pipeline runs one section and prints its own line.

Environment (bench.py's names and defaults): BENCH_BATCH (1 for infer, train
and pipeline, 4 for eval), BENCH_ITERS (20 infer, 6 train, 10 eval),
BENCH_DTYPE (bfloat16 | float32), BENCH_T and BENCH_T_VALID (padded and real
instances of the train bench, 16 / 16; the pipeline's max_instances, 20),
BENCH_COMPACT, BENCH_DISK_N (24), BENCH_DISK_ROOT (default
build/bench_disk_<h>x<w> in this checkout), BENCH_DEVICE_CHANNELS,
BENCH_PACK_TARGETS, BENCH_WORKERS (4).

How each number is taken:
- wall times: the host clock around a pipelined loop that ends in one value
  fetch (`.item()`), which waits for the whole chain on the card;
- device ms per call: torch.profiler's CUDA trace of a few more calls, the
  union of the kernel, memcpy and memset intervals (`interval_union`), so
  copies on another stream that overlap compute count once;
- FLOPs per call: one call, outside the timed loop, under torch's
  `FlopCounterMode` (the aten operations) plus the hand kernels' own formulas
  (`rgbdseg_torch.ops.kernels.FLOPS`), which the mode cannot see in a ctypes
  launch: the count `Trainer.total_flos` uses. K1 counts its function's work,
  8 operations per (sample, point, channel); the JAX bench counts XLA's cost
  analysis, where K1 is the TPU tent-matmul's dense product over the level, so
  the two MFUs are not comparable;
- MFU: those FLOPs x calls per second over the card's dense peak for the
  dtype the bench ran in (`PEAK_FLOPS`, found by the longest prefix of the
  card's name); no `mfu` for a card not in the table. In float32, TF32 is
  off, so the float32 peak outside the tensor cores applies.

Inference and eval run bench.py's serving model: every float32 parameter and
buffer (BatchNorm's running statistics too) cast to bfloat16, bfloat16 pixels.
The train bench runs the bf16 policy of `train.trainer.forward` (float32
masters, a bfloat16 copy in the forward) with AdamW at optax.adamw(1e-4)'s
settings. Baselines: the reference PyTorch repository's published 640x640
numbers on its own single GPU (BASELINE.md, `coco82v2_multi_640`
all_results.json): test_samples_per_second 0.61 (eval) and
train_samples_per_second 0.973.

It runs on the CUDA card and raises without one; `--device cpu` (or
`main(device="cpu")`, the functions' `device="cpu"`) runs it on the CPU, where
the kernel wrappers take their plain versions and no device time is reported.
"""

from __future__ import annotations

import gc
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np
import torch

from rgbdseg_torch.config import ModelConfig, PreprocessConfig
from rgbdseg_torch.data.pipeline import Batch, SegmentationDataset, compact_targets, load_meta
from rgbdseg_torch.inference.predictor import pop_device_flag, resolve_device
from rgbdseg_torch.models.mask2former import Mask2FormerRGBD
from rgbdseg_torch.ops import kernels
from rgbdseg_torch.train.arguments import TrainingArguments
from rgbdseg_torch.train.evaluator import Evaluator
from rgbdseg_torch.train.optim import AdamW
from rgbdseg_torch.train.trainer import TrainBatch, train_step
from rgbdseg_torch.utils.weights import init_weights

REPO = os.path.dirname(os.path.abspath(__file__))
REFERENCE_THROUGHPUT = 0.61  # images/s, the reference's 640² eval on its single GPU (BASELINE.md)
REFERENCE_TRAIN_THROUGHPUT = 0.973  # images/s, the reference's 640² train on its single GPU (BASELINE.md)

# Dense peak FLOP/s per card, by the prefix of torch.cuda.get_device_name() and
# the dtype the bench runs in: NVIDIA's published figures without sparsity.
# "NVIDIA H100 80GB HBM3" is the SXM5 part; float32 is outside the tensor cores
# (TF32 off).
PEAK_FLOPS = {
    "NVIDIA H100 80GB HBM3": {"bfloat16": 989.4e12, "float32": 66.9e12},
}
# The device-timeline events that are work on the card (kineto's categories).
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


def _env_int(name: str, default: int, given=None) -> int:
    return int(given) if given is not None else int(os.environ.get(name, str(default)))


def _dtype() -> torch.dtype:
    name = os.environ.get("BENCH_DTYPE", "bfloat16")
    if name not in ("bfloat16", "float32"):
        raise ValueError(f"BENCH_DTYPE={name!r}: bfloat16 or float32")
    return getattr(torch, name)


def _setup(device) -> torch.device:
    """The device (the card unless `device` names another; raises without
    CUDA), with TF32 off for float32 matmuls and convolutions."""
    dev = resolve_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return dev


def _sync(dev: torch.device) -> None:
    """Barrier after the uploads and around timed regions: the card's queue drained."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _device_kind(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else dev.type


def interval_union(pairs) -> float:
    """Total length covered by the (start, end) intervals, overlaps counted once."""
    total, covered_to = 0.0, float("-inf")
    for s, e in sorted(pairs):
        if e > covered_to:
            total += e - max(s, covered_to)
            covered_to = e
    return total


def device_intervals(trace_events) -> list[tuple[float, float]]:
    """(start, end) in µs of the work on the card in a Chrome trace's events:
    kernels, copies and memsets; not the annotations that span them."""
    return [(e["ts"], e["ts"] + e.get("dur", 0)) for e in trace_events
            if e.get("ph") == "X" and e.get("cat") in DEVICE_CATEGORIES]


def _device_ms_per_call(fn, inputs, dev: torch.device, n: int = 5):
    """Device ms per call from torch.profiler's CUDA trace of n warm calls: the
    union of the device intervals over the traced calls, over their count.
    `inputs` None: `fn` is a thunk that runs its calls and returns their count.
    None off the card (a CPU run has no device time)."""
    if dev.type != "cuda":
        return None
    from torch.profiler import ProfilerActivity, profile

    _sync(dev)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        if inputs is None:
            n = fn()
        else:
            n = min(n, len(inputs))
            for x in inputs[:n]:
                fn(x)
        _sync(dev)
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(REPO, "build")) as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    busy = interval_union(device_intervals(events))
    return round(busy / 1e3 / n, 2) if busy else None


def _count_flops(fn, *args):
    """(fn(*args), its floating-point operations): torch's FlopCounterMode over
    the aten operations plus the hand kernels' formulas (`kernels.FLOPS`), as
    `Trainer` counts `total_flos`."""
    from torch.utils.flop_counter import FlopCounterMode

    k0 = sum(kernels.FLOPS.values())
    with FlopCounterMode(display=False) as counter:
        out = fn(*args)
    return out, float(counter.get_total_flops() + sum(kernels.FLOPS.values()) - k0)


def _mfu_fields(flops_per_call: float, images_per_sec: float, batch: int, kind: str, dtype: str = "bfloat16") -> dict:
    """FLOPs per call x calls per second -> TFLOP/s, and MFU against the
    card's dense peak for `dtype` (the longest prefix of `kind` in
    PEAK_FLOPS); no `mfu` or `device_kind` for a card not in the table."""
    if flops_per_call <= 0:
        return {}
    tflops = flops_per_call * images_per_sec / batch / 1e12
    matches = [k for k in PEAK_FLOPS if kind.startswith(k)]
    peak = PEAK_FLOPS[max(matches, key=len)].get(dtype) if matches else None
    out = {"tflops_per_sec": round(tflops, 2)}
    if peak:
        out["mfu"] = round(tflops * 1e12 / peak, 4)
        out["device_kind"] = kind
    return out


def serving_model(model: Mask2FormerRGBD, dtype: torch.dtype) -> Mask2FormerRGBD:
    """bench.py's serving model, in place: eval mode, no parameter requiring a
    gradient, every floating-point parameter and buffer (BatchNorm's running
    statistics too) cast to `dtype`, as bench.py casts its whole variable tree."""
    return model.eval().requires_grad_(False).to(dtype)


def _forward(model):
    @torch.no_grad()
    def forward(px):
        out = model(px)
        return out.class_queries_logits, out.masks_queries_logits

    return forward


def _build_train_state(cfg: ModelConfig, h: int, w: int, bf16: bool, preprocess=None, device=None):
    """The model with the seeded weights (seed 0) in train mode, AdamW at
    optax.adamw(1e-4)'s settings (b1 0.9, b2 0.999, eps 1e-8, weight decay 1e-4
    on every parameter, no clipping, no schedule), and the step: raw uint8
    frames built into the stack on the device, bit-packed masks unpacked there,
    the forward under the bf16 policy of `train.trainer.forward` when `bf16`,
    the criterion with the points drawn from a seeded generator, backward and
    the update. `h` and `w` are the frames' size (bench.py's signature; the
    model takes any). Returns (step(px, masks, classes, valid) -> loss, model,
    optimizer)."""
    dev = resolve_device(device)
    model = init_weights(Mask2FormerRGBD(cfg), 0).to(dev).train()
    args = TrainingArguments(learning_rate=1e-4, weight_decay=1e-4, adam_beta1=0.9, adam_beta2=0.999,
                             adam_epsilon=1e-8, max_grad_norm=float("inf"), bf16=bf16)
    optimizer = AdamW(model.named_parameters(), args, total_steps=1)
    for group in optimizer.param_groups:  # optax.adamw has no decay mask
        group["weight_decay"] = args.weight_decay
    optimizer.schedule = lambda count: args.learning_rate
    generator = torch.Generator(device=dev).manual_seed(0)

    def step(px, masks, classes, valid):
        return train_step(model, optimizer, TrainBatch(px, masks, classes, valid), generator, preprocess)[0]

    return step, model, optimizer


def bench_train(cfg=None, h: int = 480, w: int = 640, iters=None, batch=None, device=None) -> dict:
    """Full training-step throughput (forward + matcher + losses + backward + AdamW)."""
    dev = _setup(device)
    batch = _env_int("BENCH_BATCH", 1, batch)
    iters = _env_int("BENCH_ITERS", 6, iters)
    # BENCH_T = padded max_instances, BENCH_T_VALID = real instances per image;
    # the targets are compacted to the batch's bucket before the upload, as the
    # Trainer does (BENCH_COMPACT=0 turns it off).
    t = _env_int("BENCH_T", 16)
    t_valid = min(t, _env_int("BENCH_T_VALID", t))
    compact = os.environ.get("BENCH_COMPACT", "1") == "1"
    cfg = cfg or ModelConfig(num_labels=40, version="0.4.0")
    dtype = _dtype()
    rng = np.random.RandomState(0)
    step, _, _ = _build_train_state(cfg, h, w, dtype == torch.bfloat16, device=dev)

    batches = []
    for _ in range(iters + 1):
        px = rng.rand(batch, h, w, 10).astype(np.float32)
        masks = (rng.rand(batch, t, h, w) > 0.7).astype(np.float32)
        classes = rng.randint(0, cfg.num_labels, (batch, t)).astype(np.int32)
        valid = np.zeros((batch, t), bool)
        valid[:, :t_valid] = True
        masks[~valid] = 0.0
        if compact:
            masks, classes, valid = compact_targets(masks, classes, valid)
        batches.append(tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in (px, masks, classes, valid)))
    t_step = batches[0][1].shape[1]  # the slots the step sees
    _sync(dev)

    loss, flops_per_call = _count_flops(step, *batches[0])
    loss.item()
    t0 = time.perf_counter()
    for b in batches[1:]:
        loss = step(*b)
    loss.item()  # a value fetch: the loss depends on the whole chain of steps
    dt = time.perf_counter() - t0

    def traced_steps():
        traced = batches[1:4]
        for b in traced:
            out = step(*b)
        out.item()
        return len(traced)

    device_ms = _device_ms_per_call(traced_steps, None, dev)
    images_per_sec = batch * iters / dt
    return {
        "metric": "NYUv2 640x480 train images/sec/chip (full step, v0.4.0)",
        "value": round(images_per_sec, 3),
        "unit": "images/sec",
        "vs_baseline": round(images_per_sec / REFERENCE_TRAIN_THROUGHPUT, 2),
        **_mfu_fields(flops_per_call, images_per_sec, batch, _device_kind(dev), str(dtype).removeprefix("torch.")),
        "wall_ms_per_step": round(dt * 1e3 / iters, 1),
        **({"device_ms_per_step": device_ms} if device_ms else {}),
        **({"max_instances": t, "real_instances": t_valid, "step_instances": t_step}
           if (t, t_valid) != (16, 16) else {}),
    }


def _box_masks(rng, batch: int, t: int, h: int, w: int) -> np.ndarray:
    """bench.py's eval GT: one square box per slot (80 px at 480x640)."""
    side = min(80, h // 4, w // 4)
    masks = np.zeros((batch, t, h, w), np.float32)
    for b in range(batch):
        for j in range(t):
            y0, x0 = rng.randint(0, h - side), rng.randint(0, w - side)
            masks[b, j, y0 : y0 + side, x0 : x0 + side] = 1.0
    return masks


def bench_eval(cfg=None, h: int = 480, w: int = 640, iters=None, batch=None, device=None) -> dict:
    """End-to-end eval throughput: forward + instance post-processing at the
    original image size + streaming mAP update, the work behind the reference's
    test_samples_per_second (predict + post-process + metric)."""
    dev = _setup(device)
    batch = _env_int("BENCH_BATCH", 4, batch)
    iters = _env_int("BENCH_ITERS", 10, iters)
    t = 8
    cfg = cfg or ModelConfig(num_labels=40, version="0.4.0")
    dtype = _dtype()
    forward = _forward(serving_model(init_weights(Mask2FormerRGBD(cfg), 0), dtype).to(dev))

    rng = np.random.RandomState(0)
    xs = [torch.from_numpy(rng.rand(batch, h, w, 10)).to(dtype).to(dev) for _ in range(iters)]
    _sync(dev)
    gts = []
    for _ in range(iters):
        masks = _box_masks(rng, batch, t, h, w)
        gts.append(Batch(
            # the evaluator reads the batch size only: a broadcast view, no memory
            pixel_values=np.broadcast_to(np.zeros((), np.float32), (batch, h, w, 10)),
            mask_labels=masks,
            class_labels=rng.randint(0, cfg.num_labels, (batch, t)).astype(np.int32),
            valid=np.ones((batch, t), bool),
            orig_sizes=np.tile([[h, w]], (batch, 1)).astype(np.int32),
            # pre-packed GT, as the pipeline's worker threads provide it
            mask_labels_packed=np.packbits(masks.astype(bool).reshape(batch, t, -1), axis=-1),
        ))

    evaluator = Evaluator({i: str(i) for i in range(cfg.num_labels)}, threshold=0.0, eval_at_original_size=True)
    # Warm the forward and the post-processing and drain paths, then start clean.
    evaluator.update(*forward(xs[0]), gts[0])
    evaluator.flush()
    evaluator.reset()
    _sync(dev)

    t0 = time.perf_counter()
    # One-batch pipeline: the next forward is queued before the host
    # post-processes the current batch's statistics.
    pending = None
    for x, gt in zip(xs, gts):
        logits = forward(x)
        if pending is not None:
            evaluator.update(*pending)
        pending = (*logits, gt)
    evaluator.update(*pending)
    evaluator.flush()  # every mAP update inside the timed region
    dt = time.perf_counter() - t0
    t0 = time.perf_counter()
    evaluator.compute()
    dt_compute = time.perf_counter() - t0

    images_per_sec = batch * iters / dt
    return {
        "metric": "NYUv2 640x480 EVAL images/sec/chip (forward + post-process + mAP update, v0.4.0)",
        "value": round(images_per_sec, 3),
        "unit": "images/sec",
        "vs_baseline": round(images_per_sec / REFERENCE_THROUGHPUT, 2),
        "metric_compute_s": round(dt_compute, 2),
    }


def bench_pipeline(cfg=None, h: int = 480, w: int = 640, iters=None, batch=None, device=None) -> dict:
    """Train throughput fed from the disk pipeline: PNG decode, packed raw
    frames (the channels built on the card inside the step) and bit-packed GT,
    two epochs over BENCH_DISK_N synthetic NYUv2-like examples. Reports:
    - pipeline_cold_img_s: the feed rate of the first epoch (decode and build);
    - pipeline_cached_img_s: the feed rate from the item cache;
    - value: train images/s with batches pulled from the pipeline (collation,
      compact_targets and the upload included);
    - upload_bound_img_s: images/s the card's host-to-device copies alone
      would allow, from one batch's bytes over its synchronised copy time in
      this run. `iters` is unused: the epochs set the steps."""
    dev = _setup(device)
    n = _env_int("BENCH_DISK_N", 24)
    batch = _env_int("BENCH_BATCH", 1, batch)
    root = os.environ.get("BENCH_DISK_ROOT", os.path.join(REPO, "build", f"bench_disk_{h}x{w}"))
    cfg = cfg or ModelConfig(num_labels=40, version="0.4.0")
    if not os.path.exists(os.path.join(root, "train.json")):
        from rgbdseg_torch.data import synthetic

        # NYUv2-like density (10-12 instances per image): every batch in the
        # compaction bucket of 16, as the synthetic train bench.
        synthetic.generate(root, num_train=n, num_valid=1, size=(h, w), seed=0, num_objects=(10, 13))
    records = load_meta(os.path.join(root, "train.json"), root)[:n]
    pp = PreprocessConfig(height=h, width=w)
    ds = SegmentationDataset(records, cfg.version, pp, max_instances=_env_int("BENCH_T", 20),
                             device_channels=os.environ.get("BENCH_DEVICE_CHANNELS", "1") == "1")
    ds.pack_gt = os.environ.get("BENCH_PACK_TARGETS", "1") == "1"
    workers = _env_int("BENCH_WORKERS", 4)

    def feed_epoch():
        t0, c = time.perf_counter(), 0
        for b in ds.batches(batch, num_workers=workers):
            c += b.pixel_values.shape[0]
        return c / (time.perf_counter() - t0)

    cold = feed_epoch()
    cached = feed_epoch()

    step, _, _ = _build_train_state(cfg, h, w, _dtype() == torch.bfloat16, preprocess=pp, device=dev)

    def host_arrays(b):
        if b.mask_labels_packed is not None:
            _, cl, vd, mk = compact_targets(b.mask_labels, b.class_labels, b.valid, packed=b.mask_labels_packed)
        else:
            mk, cl, vd = compact_targets(b.mask_labels, b.class_labels, b.valid)
        return b.pixel_values, mk, cl, vd

    def put(b):
        return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in host_arrays(b))

    it = ds.batches(batch, num_workers=workers)
    first = next(it)
    loss = step(*put(first))
    loss.item()  # warm: cuDNN and cuBLAS set-up, the fetch

    # The card's host-to-device rate: one batch's upload, synchronised on both sides.
    put(first)
    _sync(dev)
    t0 = time.perf_counter()
    up = put(first)
    _sync(dev)
    copy_s = time.perf_counter() - t0
    upload_bytes = sum(x.numel() * x.element_size() for x in up)

    t0, c = time.perf_counter(), 0
    for src in (it, ds.batches(batch, num_workers=workers)):
        for b in src:
            loss = step(*put(b))
            c += b.pixel_values.shape[0]
    loss.item()
    dt = time.perf_counter() - t0

    images_per_sec = c / dt
    return {
        "metric": "NYUv2 640x480 train images/sec fed from the REAL disk pipeline (v0.4.0)",
        "value": round(images_per_sec, 3),
        "unit": "images/sec",
        "vs_baseline": round(images_per_sec / REFERENCE_TRAIN_THROUGHPUT, 2),
        "pipeline_cold_img_s": round(cold, 2),
        "pipeline_cached_img_s": round(cached, 2),
        "upload_bound_img_s": round((upload_bytes / copy_s) / (upload_bytes / batch), 2),
        "device_channels": ds.device_channels,
        "host_cores": os.cpu_count(),
    }


def bench_infer(cfg=None, h: int = 480, w: int = 640, iters=None, batch=None, device=None) -> dict:
    """Inference throughput of the serving model, with MFU."""
    dev = _setup(device)
    batch = _env_int("BENCH_BATCH", 1, batch)
    iters = _env_int("BENCH_ITERS", 20, iters)
    cfg = cfg or ModelConfig(num_labels=40, version="0.4.0")
    dtype = _dtype()
    rng = np.random.RandomState(0)
    forward = _forward(serving_model(init_weights(Mask2FormerRGBD(cfg), 0), dtype).to(dev))

    # A distinct input per iteration; xs[0] warms up and stays out of the timed loop.
    xs = [torch.from_numpy(rng.rand(batch, h, w, 10)).to(dtype).to(dev) for _ in range(iters + 1)]
    _sync(dev)
    out, flops_per_call = _count_flops(forward, xs[0])
    out = forward(xs[0])
    out[0].reshape(-1)[0].item()

    # Headline: one pipelined loop, one drain fetch at the end.
    timed = xs[1:]
    t0 = time.perf_counter()
    outs = [forward(x) for x in timed]
    outs[-1][0].reshape(-1)[0].item()
    dt = time.perf_counter() - t0
    del outs

    # Five chunks of iters/5, each ending in its own fetch: an irregular chunk
    # with a normal device time points at the host, not the card.
    per = max(1, iters // 5)
    chunk_ms = []
    for c in range(0, len(timed), per):
        t0c = time.perf_counter()
        for x in timed[c : c + per]:
            out = forward(x)
        out[0].reshape(-1)[0].item()
        chunk_ms.append((time.perf_counter() - t0c) * 1e3 / (batch * min(per, len(timed) - c)))
    chunk_ms = sorted(round(m, 1) for m in chunk_ms)
    device_ms = _device_ms_per_call(forward, timed, dev)
    if device_ms:
        device_ms = round(device_ms / batch, 2)

    images_per_sec = batch * iters / dt
    return {
        "metric": "NYUv2 640x480 images/sec/chip (inference, v0.4.0)",
        "value": round(images_per_sec, 3),
        "unit": "images/sec",
        "vs_baseline": round(images_per_sec / REFERENCE_THROUGHPUT, 2),
        **_mfu_fields(flops_per_call, images_per_sec, batch, _device_kind(dev), str(dtype).removeprefix("torch.")),
        "wall_ms_per_image": round(dt * 1e3 / (batch * iters), 2),
        "chunk_ms_per_image": chunk_ms,
        **({"device_ms_per_image": device_ms} if device_ms else {}),
    }


def _release() -> None:
    """Free the last bench's model and tensors before the next one's."""
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def main(argv=None, device=None) -> dict:
    """Run the mode BENCH_MODE names (default all: inference, train and eval,
    merged into the inference line) and print one JSON line; returns it."""
    argv, flag_device = pop_device_flag(list(sys.argv[1:] if argv is None else argv))
    if argv:
        raise SystemExit(f"bench_torch.py takes only --device; got {argv}")
    device = device or flag_device
    resolve_device(device)  # no card and no --device cpu: raise before any work
    mode = os.environ.get("BENCH_MODE", "all")
    single = {"infer": bench_infer, "train": bench_train, "eval": bench_eval, "pipeline": bench_pipeline}
    if mode in single:
        result = single[mode](device=device)
    elif mode == "all":
        result = bench_infer(device=device)
        _release()
        train = bench_train(device=device)
        _release()
        ev = bench_eval(device=device)
        result.update({
            "train_images_per_sec": train["value"],
            "train_vs_baseline": train["vs_baseline"],
            **({"train_mfu": train["mfu"]} if "mfu" in train else {}),
            **({"train_device_ms_per_step": train["device_ms_per_step"]} if "device_ms_per_step" in train else {}),
            "eval_images_per_sec": ev["value"],
            "eval_vs_baseline": ev["vs_baseline"],
            "eval_metric_compute_s": ev["metric_compute_s"],
        })
    else:
        raise SystemExit(f"BENCH_MODE={mode!r}: all, infer, train, eval or pipeline")
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
