"""Time the port's CUDA kernels against an earlier commit's, in one process on one card.

    python3 kernel_ab.py --parent DIR [--seed N] [--requests N] [--kernels-only]

DIR is a checkout of the earlier commit (e.g. `git archive <commit>` unpacked
into `build/parent`). Its package is imported under another name and builds
its own sources into `DIR/build/kernels`. Every kernel is timed at main-path
shapes in the order old, new, new, old, both as device time (a replayed CUDA
graph) and as eager time per call from Python (see `chip_smoke.py`), and both
are held against the plain version first. Sections, each run where the parent
has what it needs (else it says so and is skipped):

- trace: for both commits, the registers, stack frame and shared memory of
  every kernel instantiation as its binary records them (`cuobjdump
  -res-usage`), and the local-memory (LDL, STL) and tensor-core (HMMA, by
  operand kind) instructions in its SASS (`cuobjdump -sass`).
- forward, for a parent with the one-launch K1 (`deform_sample_levels`): K1
  (one encoder layer, 3 levels, in-model geometry) and K3 at K = 300, 1200
  and 4800, at B=2, with float32 and with bfloat16 operands; whether old and
  new give the same bits, and whether the new K1 on bf16 V gives the bits of
  its f32 route on V.float().
- backward, for a parent with backward kernels (`_launch_bwd` in both kernel
  modules, the third slice's signatures): the launch each autograd backward
  makes, at the train shapes (B=2), float32 and bfloat16 operands (bf16 held
  against the plain backward in bf16): K1 at the in-model and the "spread"
  geometries (`chip_smoke.k1_inputs`), K3 at K = 300, 1200 and 4800 on the
  log-sum-exp of this tree's forward; whether old and new give the same bits
  (K1's d value apart: the parent adds it with float atomics), and whether two
  launches of this tree's K1 backward do; each launch's per-kernel split, the
  parent's zeroing and bf16 cast of d value counted on its side.
- point sampling: the criterion's gradient to the mask logits at the train
  phase's geometry, as the parent computes it (aten's
  `grid_sampler_2d_backward` where it has no point-sampling kernel) and as
  this tree's kernel does, each held against the plain backward; whether two
  launches of each give the same bits; each launch's per-kernel split.
- requests (not with --kernels-only): both commits' full-width 0.4.0 models,
  with the same seeded weights, serve the same 480x640 frame in turns old,
  new, new, old (`--requests` rounds): median request ms of each, and their
  logits' difference.
- train steps (not with --kernels-only), for a parent with
  `train.trainer.train_step`: both commits' full-width models, with the same
  seeded weights, take `chip_smoke.py` phase 6's train step (batch 2 of
  480x640 float stacks, 16 box slots) in turns old, new, new, old
  (`--requests` rounds): median step ms of each.

Prints one line per shape and a JSON line; needs one CUDA card.

    python3 kernel_ab.py --cudnn-cost [--seed N] [--requests N]

runs, instead, this tree's float32 train step (`chip_smoke.py` phase 6's
batch) with cuDNN's default algorithms and with its deterministic ones (as the
training entries set them), in turns default, deterministic, deterministic,
default: device ms per step (the sum of its kernels' device times over
`--requests` profiled steps each) and the kernels whose time differs most.

    python3 kernel_ab.py --parent DIR --parallel [--seed N]

runs, instead, `chip_smoke.py` phase 18 (the parallel phase: two processes
sharing the card, their eval by both routes) of the parent and of this tree
in turns, parent, tree, tree, parent, each in a process of its own with its
own package, after the phases that give it its inputs (10: the eval set; 12:
the step-0 weights and batch); each prints its readings as `chip_smoke.py`
prints them.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np

import chip_smoke as cs


def load_parent(parent: Path):
    """The earlier commit's kernel modules (deformable, masked_attention) and
    predictor module, from its `rgbdseg_torch` imported as `parent_rgbdseg_torch`."""
    name = "parent_rgbdseg_torch"
    spec = importlib.util.spec_from_file_location(
        name, parent / "rgbdseg_torch" / "__init__.py", submodule_search_locations=[str(parent / "rgbdseg_torch")]
    )
    sys.modules[name] = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(sys.modules[name])
    return tuple(importlib.import_module(f"{name}.{m}")
                 for m in ("ops.kernels.deformable", "ops.kernels.masked_attention", "inference.predictor"))


def backward_ab(old_deform, old_mca, rng) -> list[dict]:
    """The backward section: the parent's and this tree's backward launches at the
    train shapes, float32 and bfloat16 operands, each held against the plain
    backward first (bf16: the plain backward in bf16), and split by kernel
    (profiler). The parent's K1 side pays what its step paid for d value (its
    zeroing, and in bf16 the cast); this tree's K1 backward must give the same
    bits in two launches. Where this tree left a route as it was, its outputs
    have the parent's bits (the parent's K1 d value apart: float atomics)."""
    import torch

    from rgbdseg_torch.ops.kernels import deformable as KD
    from rgbdseg_torch.ops.kernels import masked_attention as KM

    dev = torch.device("cuda")
    rows = []
    starts = [sum(h * w for h, w in cs.LEVELS[:i]) for i in range(len(cs.LEVELS))]
    for geometry in ("model", "spread"):
        value, loc, weights = cs.k1_inputs(rng, dev, geometry, cs.TRAIN_B)
        g = torch.from_numpy(rng.randn(cs.TRAIN_B, cs.L, cs.NH * cs.HD).astype(np.float32)).to(dev)
        for vt, dv_rtol in ((value, cs.K1_BWD_RTOL), (value.bfloat16(), cs.K1_BWD_RTOL_BF16_DV)):
            dtype = str(vt.dtype).replace("torch.", "")

            def old():  # what the parent's train step pays for d value: the zeroing, the kernel, the cast
                d_value, d_loc, d_w = old_deform._launch_bwd(vt, loc, weights, cs.LEVELS, starts, True, g)
                return d_value.to(vt.dtype), d_loc, d_w

            def new():
                return KD._launch_bwd(vt, loc, weights, cs.LEVELS, starts, True, g)

            ref = KD.deform_sample_levels_plain_bwd(vt, cs.LEVELS, loc, weights, g)
            outs = {}
            for label, fn in (("old", old), ("new", new)):
                outs[label] = fn()
                cs._check_grads(f"ab K1-bwd {geometry} {dtype} {label} d value", outs[label][:1], ref[:1], dv_rtol)
                cs._check_grads(f"ab K1-bwd {geometry} {dtype} {label} d loc, d weights", outs[label][1:], ref[1:],
                                cs.K1_BWD_RTOL)
            same = all(torch.equal(a, b) for a, b in zip(outs["old"][1:], outs["new"][1:]))
            again = all(torch.equal(a, b) for a, b in zip(outs["new"], new()))
            if not again:
                raise AssertionError(f"K1-bwd {geometry} {dtype}: two launches give different bits")
            cs.log(f"ab K1-bwd {geometry} {dtype}: d loc and d weights old == new bit for bit: {same}; new: two "
                   f"launches give the same bits (d value, d loc, d weights); d value {outs['new'][0].dtype} "
                   f"from the kernels")
            split = {label: kernel_split(fn) for label, fn in (("old", old), ("new", new))}
            for label, ms in split.items():
                cs.log(f"ab K1-bwd {geometry} {dtype} {label} per kernel: "
                       + ", ".join(f"{k} {v:.4f} ms" for k, v in ms.items()))
            rows.append(dict(kernel="K1-bwd", dtype=dtype, same_bits=same, kernels_ms=split, **ab(
                f"K1-bwd one encoder layer, {geometry} geometry, {dtype} V, B={cs.TRAIN_B}", old, new)))
    for nk in cs.KEYS:
        q, k, v, m, ab_ = cs.mca_inputs(rng, nk, dev, cs.TRAIN_B)
        g = torch.from_numpy(rng.randn(*q.shape).astype(np.float32)).to(dev)
        for dt, rtol in ((torch.float32, cs.K3_BWD_RTOL), (torch.bfloat16, cs.K3_BWD_RTOL_BF16)):
            qd, kd, vd, gd = (t.to(dt) for t in (q, k, v, g))
            out, lse = KM._launch(qd, kd, vd, m, ab_)
            dtype = str(dt).replace("torch.", "")

            def old():
                return old_mca._launch_bwd(qd, kd, vd, m, ab_, out, lse, gd)

            def new():
                return KM._launch_bwd(qd, kd, vd, m, ab_, out, lse, gd)

            ref = [r.float() for r in KM.masked_cross_attention_plain_bwd(qd, kd, vd, m, ab_, gd)]
            outs = {}
            for label, fn in (("old", old), ("new", new)):
                outs[label] = fn()
                cs._check_grads(f"ab K3-bwd K={nk} {dtype} {label}", [t.float() for t in outs[label]], ref, rtol,
                                joint=True)
            same = all(torch.equal(a, b) for a, b in zip(outs["old"], outs["new"]))
            cs.log(f"ab K3-bwd K={nk} {dtype}: old == new bit for bit: {same}; dtypes old "
                   f"{[str(t.dtype) for t in outs['old']]}, new {[str(t.dtype) for t in outs['new']]}")
            split = {label: kernel_split(fn) for label, fn in (("old", old), ("new", new))}
            for label, ms in split.items():
                cs.log(f"ab K3-bwd K={nk} {dtype} {label} per kernel: "
                       + ", ".join(f"{k} {v:.4f} ms" for k, v in ms.items()))
            rows.append(dict(kernel="K3-bwd", dtype=dtype, same_bits=same, kernels_ms=split,
                             **ab(f"K3-bwd K={nk} {dtype} B={cs.TRAIN_B}", old, new)))
    torch.cuda.synchronize()
    return rows


def point_sample_ab(parent_kernels, rng) -> list[dict]:
    """The point-sampling section: the criterion's gradient to the mask logits
    at the train phase's geometry (`chip_smoke.point_sample_inputs`), as the
    parent computes it where it has no point-sampling kernel (aten's
    `grid_sampler_2d_backward`, float atomics) and as this tree's kernel does,
    each held against the plain backward first; whether two launches of each
    give the same bits; the per-kernel split."""
    import torch

    from rgbdseg_torch.ops.kernels import point_sample as KP

    masks, coords = cs.point_sample_inputs(rng, torch.device("cuda"))[1]
    b, n, npts, _ = coords.shape
    h, w = masks.shape[2:]
    g = torch.from_numpy(rng.randn(b, n, npts).astype(np.float32)).cuda()
    if "point_sample_bwd" in parent_kernels._SIGNATURES:
        old_mod = importlib.import_module("parent_rgbdseg_torch.ops.kernels.point_sample")

        def old():
            return old_mod._launch_bwd(coords, g, h, w)
    else:
        grid = (2.0 * coords - 1.0).reshape(b * n, 1, npts, 2)
        img, go = masks.reshape(b * n, 1, h, w), g.reshape(b * n, 1, 1, npts)

        def old():
            return torch.ops.aten.grid_sampler_2d_backward(go, img, grid, 0, 0, False, [True, False])[0].reshape(
                b, n, h, w)

    def new():
        return KP._launch_bwd(coords, g, h, w)

    ref = KP.point_sample_plain_bwd(masks, coords, g)
    same = {}
    for label, fn in (("old", old), ("new", new)):
        cs._check_grads(f"ab point_sample_bwd {label}", [fn()], [ref], cs.POINT_BWD_RTOL)
        same[label] = torch.equal(fn(), fn())
    if not same["new"]:
        raise AssertionError("point_sample_bwd: two launches give different bits")
    cs.log(f"ab point_sample_bwd: two launches give the same bits: old {same['old']}, new {same['new']}")
    split = {label: kernel_split(fn) for label, fn in (("old", old), ("new", new))}
    for label, ms in split.items():
        cs.log(f"ab point_sample_bwd {label} per kernel: " + ", ".join(f"{k} {v:.4f} ms" for k, v in ms.items()))
    return [dict(kernel="point_sample_bwd", dtype="float32", same_bits=same, kernels_ms=split,
                 **ab(f"point_sample_bwd {b}x{n} masks {h}x{w}, P={npts}", old, new))]


def requests_ab(old_predictor_mod, seed: int, rng, n: int) -> dict:
    """The full-width 0.4.0 model of both commits (same seeded weights), serving the
    same frames in turns old, new, new, old; request ms and the logits' difference."""
    import torch

    from rgbdseg_torch.config import ModelConfig
    from rgbdseg_torch.inference.predictor import Predictor

    old_cfg = sys.modules["parent_rgbdseg_torch.config"].ModelConfig(num_labels=40, version="0.4.0")
    preds = {"old": old_predictor_mod.Predictor(old_cfg, device="cuda", seed=seed),
             "new": Predictor(ModelConfig(num_labels=40, version="0.4.0"), device="cuda", seed=seed)}
    frame = cs.frame_stack(*cs.synthetic_frame(rng)[:2])[None]
    with torch.no_grad():
        logits = {k: p._forward(torch.from_numpy(frame).cuda()) for k, p in preds.items()}
    diff = max((a - b).abs().max().item() for a, b in zip(logits["old"], logits["new"]))
    times = {"old": [], "new": []}
    for k in ("old", "new", "new", "old"):  # warm-up, in the timed order
        preds[k].predict_pixels(frame, threshold=0.0)
    for _ in range(n):
        for k in ("old", "new", "new", "old"):
            times[k].append(cs._timed(lambda: preds[k].predict_pixels(frame, threshold=0.0))[1])
    med = {k: sorted(v)[len(v) // 2] for k, v in times.items()}
    cs.log(f"ab requests ({2 * n} each, turns old/new/new/old): median old {med['old']:.2f} ms, "
           f"new {med['new']:.2f} ms; min old {min(times['old']):.2f}, new {min(times['new']):.2f}; "
           f"logits old vs new max_abs_diff {diff:.3e}")
    return {"median_ms": med, "ms": times, "logits_max_abs_diff": diff}


def train_ab(seed: int, rng, n: int) -> dict:
    """Phase 6's train step on both commits' full-width 0.4.0 models (same seeded
    weights, the same batch, a generator each), in turns old, new, new, old."""
    import torch

    from rgbdseg_torch.config import ModelConfig
    from rgbdseg_torch.train import trainer as new_trainer
    from rgbdseg_torch.train.arguments import TrainingArguments

    old_trainer = importlib.import_module("parent_rgbdseg_torch.train.trainer")
    old_args = importlib.import_module("parent_rgbdseg_torch.train.arguments").TrainingArguments
    old_cfg = sys.modules["parent_rgbdseg_torch.config"].ModelConfig(num_labels=40, version="0.4.0")
    kw = dict(learning_rate=1e-4, weight_decay=0.05, per_device_train_batch_size=cs.TRAIN_B)
    trainers = {"old": old_trainer, "new": new_trainer}
    state = {"old": old_trainer.build_training(old_cfg, old_args(**kw), 8, seed=seed),
             "new": new_trainer.build_training(ModelConfig(num_labels=40, version="0.4.0"), TrainingArguments(**kw), 8,
                                               seed=seed)}
    frames, masks = [], []
    for _ in range(cs.TRAIN_B):
        rgb, depth, inst = cs.synthetic_frame(rng, boxes=cs.TRAIN_T)
        frames.append(cs.frame_stack(rgb, depth))
        masks.append(np.stack([inst == i + 1 for i in range(cs.TRAIN_T)]).astype(np.float32))
    masks = np.stack(masks)
    arrays = (np.stack(frames), masks, rng.randint(0, 40, (cs.TRAIN_B, cs.TRAIN_T)), masks.any(axis=(2, 3)))
    batch = new_trainer.TrainBatch(*(torch.from_numpy(np.ascontiguousarray(a)).cuda() for a in arrays))
    gens = {k: torch.Generator(device="cuda").manual_seed(seed) for k in trainers}

    def step(k):
        return trainers[k].train_step(*state[k], batch, gens[k])

    times = {"old": [], "new": []}
    for k in ("old", "new", "new", "old"):  # warm-up (step 0 pays cuDNN and cuBLAS set-up), in the timed order
        step(k)
    for _ in range(n):
        for k in ("old", "new", "new", "old"):
            times[k].append(cs._timed(lambda: step(k))[1])
    med = {k: sorted(v)[len(v) // 2] for k, v in times.items()}
    cs.log(f"ab train steps ({2 * n} each, turns old/new/new/old): median old {med['old']:.2f} ms, "
           f"new {med['new']:.2f} ms; min old {min(times['old']):.2f}, new {min(times['new']):.2f}")
    return {"median_ms": med, "ms": times}


def kernel_split(fn, n: int = 20) -> dict:
    """Device ms per call of each kernel `fn` launches, from torch.profiler over n calls."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    return {e.key.replace("(anonymous namespace)::", "").split("(")[0].removeprefix("void ")[:48]:
            e.self_device_time_total / n / 1e3 for e in sorted(events, key=lambda e: -e.self_device_time_total)}


def ab(label: str, old, new, iters: int = 50) -> dict:
    """Device ms (CUDA graph) and eager ms per call, each in the order old, new, new, old."""
    row = {"shape": label}
    for kind, timer in (("ms", cs.time_ms), ("eager_ms", cs.eager_ms)):
        t = [timer(f, iters) for f in (old, new, new, old)]
        row[f"old_{kind}"], row[f"new_{kind}"] = [t[0], t[3]], [t[1], t[2]]
        cs.log(f"ab {label} {kind}: old {t[0]:.4f} / {t[3]:.4f}, new {t[1]:.4f} / {t[2]:.4f}, "
               f"speedup {min(t[0], t[3]) / max(t[1], t[2]):.2f}x (slowest new against fastest old)")
    return row


def _agree(label: str, old, new, ref, tol: float) -> None:
    errs = {"old": (old() - ref).abs().max().item(), "new": (new() - ref).abs().max().item()}
    cs.log(f"ab {label} max_abs_err vs plain: old {errs['old']:.3e}, new {errs['new']:.3e}")
    if not max(errs.values()) <= tol:
        raise AssertionError(f"{label} disagrees with the plain version: {errs}")


def cudnn_cost(seed: int, rounds: int) -> dict:
    """`--cudnn-cost`: the float32 train step with
    `torch.backends.cudnn.deterministic` False and True in turns; per setting
    the device ms per step (torch.profiler, the sum of the kernels' device
    times) and every kernel's ms per step; logs the kernels whose time moved
    most."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from rgbdseg_torch.config import ModelConfig
    from rgbdseg_torch.train.arguments import TrainingArguments
    from rgbdseg_torch.train.trainer import build_training, train_step

    cfg = ModelConfig(num_labels=40, version="0.4.0")
    model, opt = build_training(cfg, TrainingArguments(learning_rate=1e-4, weight_decay=0.05,
                                                       per_device_train_batch_size=cs.TRAIN_B), 8, seed=seed)
    batch = cs.stack_batch(np.random.RandomState(seed), cfg)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    per_kernel = {False: {}, True: {}}
    totals = {False: [], True: []}
    for flag in (False, True, True, False):
        torch.backends.cudnn.deterministic = flag
        train_step(model, opt, batch, gen)  # the algorithms of this setting chosen and warm
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(rounds):
                train_step(model, opt, batch, gen)
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        totals[flag].append(sum(e.self_device_time_total for e in events) / rounds / 1e3)
        for e in events:
            name = e.key.split("(")[0].removeprefix("void ")[:72]
            per_kernel[flag][name] = per_kernel[flag].get(name, 0.0) + e.self_device_time_total / rounds / 1e3 / 2
    torch.backends.cudnn.deterministic = True
    moved = sorted(set(per_kernel[False]) | set(per_kernel[True]),
                   key=lambda k: -abs(per_kernel[True].get(k, 0.0) - per_kernel[False].get(k, 0.0)))
    cs.log(f"cudnn cost: float32 train step device ms, default algorithms {totals[False]}, deterministic "
           f"{totals[True]} (turns default, deterministic, deterministic, default; {rounds} steps each)")
    for k in moved[:12]:
        cs.log(f"cudnn cost: {per_kernel[False].get(k, 0.0):.4f} -> {per_kernel[True].get(k, 0.0):.4f} ms per step "
               f"{k}")
    return {"device_ms": totals, "kernels_ms": per_kernel}


def phase18(root: Path, seed: int) -> int:
    """`chip_smoke.py` phase 18 of the checkout at `root`, with its package, in
    this process (which must not have imported `rgbdseg_torch` yet)."""
    sys.path.insert(0, str(root))
    spec = importlib.util.spec_from_file_location("ab_chip_smoke", root / "chip_smoke.py")
    smoke = sys.modules[spec.name] = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    import torch

    from rgbdseg_torch.config import ModelConfig, PreprocessConfig
    from rgbdseg_torch.inference.predictor import Predictor
    from rgbdseg_torch.ops.kernels import build_all

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smoke.log(f"phase 18 of {root}: kernels built in {build_all():.1f} s [{smi}]")
    rng = np.random.RandomState(seed)
    pred = Predictor(ModelConfig(num_labels=40, version="0.4.0"), device="cuda", seed=seed,
                     preprocess=PreprocessConfig(height=480, width=640))
    eval_set = smoke.run_eval(rng, pred)
    del pred
    step0, micro, _ = smoke.run_train_full(seed, rng)
    _, ms = smoke._timed(lambda: smoke.run_parallel(seed, rng, step0, micro[0], eval_set, root, card=smi))
    smoke.log(f"phase 18 of {root}: {ms / 1e3:.1f} s [{smi}]")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, default=None, help="checkout of the earlier commit")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--requests", type=int, default=10,
                    help="timed rounds of old/new/new/old requests, and of train steps")
    ap.add_argument("--kernels-only", action="store_true",
                    help="the trace and the kernel sections only (no requests, no train steps)")
    ap.add_argument("--parallel", action="store_true",
                    help="instead: chip_smoke.py phase 18 of the parent and of this tree in turns")
    ap.add_argument("--cudnn-cost", action="store_true",
                    help="instead: this tree's float32 train step with cuDNN's default and deterministic algorithms")
    ap.add_argument("--phase18-of", type=Path, default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.parent is None and not args.cudnn_cost and args.phase18_of is None:
        ap.error("--parent is required (except with --cudnn-cost)")
    if args.phase18_of is not None:
        return phase18(args.phase18_of.resolve(), args.seed)
    if args.parallel:
        here = Path(__file__).resolve().parent
        return max(subprocess.run([sys.executable, __file__, "--parent", str(args.parent), "--seed", str(args.seed),
                                   "--phase18-of", str(root)]).returncode
                   for root in (args.parent, here, here, args.parent))
    import torch

    if not torch.cuda.is_available():
        print("kernel_ab.py: no CUDA device", file=sys.stderr)
        return 1
    from rgbdseg_torch.ops.kernels import build_all

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.cudnn_cost:
        cs.log(f"device: {smi}; kernels built in {build_all():.1f} s; TF32 off")
        print(json.dumps({"device": smi, "cudnn_cost": cudnn_cost(args.seed, args.requests)}))
        return 0
    cs.log(f"device: {smi}; parent {args.parent}; TF32 off")
    build_all()
    old_deform, old_mca, old_predictor = load_parent(args.parent.resolve())
    parent_kernels = importlib.import_module("parent_rgbdseg_torch.ops.kernels")
    parent_kernels.build_all()
    traced = trace(parent_kernels)
    rng = np.random.RandomState(args.seed)
    rows = []
    if hasattr(old_deform, "deform_sample_levels"):
        rows += forward_ab(old_deform, old_mca, rng)
    else:
        cs.log("ab: the parent has no one-launch K1 forward; forward section skipped")
    if all(hasattr(mod, "_launch_bwd") for mod in (old_deform, old_mca)):
        rows += backward_ab(old_deform, old_mca, rng)
    else:
        cs.log("ab: the parent has no backward kernels; backward section skipped")
    rows += point_sample_ab(parent_kernels, rng)
    torch.cuda.synchronize()
    e2e = steps = None
    if not args.kernels_only:
        e2e = requests_ab(old_predictor, args.seed, rng, args.requests)
        if hasattr(importlib.import_module("parent_rgbdseg_torch.train.trainer"), "train_step"):
            steps = train_ab(args.seed, rng, args.requests)
        else:
            cs.log("ab: the parent has no train step; train section skipped")
    print(json.dumps({"device": smi, "trace": traced, "ab": rows, "requests": e2e, "train_steps": steps}))
    return 0


def forward_ab(old_deform, old_mca, rng) -> list[dict]:
    """The forward section: K1 (one encoder layer, all levels, in-model
    geometry) and K3 of the parent and of this tree at the bf16 step's shapes
    (B=2), float32 and bfloat16 operands, each held against the plain version
    first; whether old and new give the same bits, and (bf16 V) whether the new
    K1 gives the bits of its f32 route on V.float()."""
    import torch

    from rgbdseg_torch.ops.kernels import deformable as KD
    from rgbdseg_torch.ops.kernels import masked_attention as KM

    dev = torch.device("cuda")
    rows = []
    value, loc, weights = cs.k1_inputs(rng, dev, "model", cs.TRAIN_B)
    for vt in (value, value.bfloat16()):
        dtype = str(vt.dtype).replace("torch.", "")

        def old():
            return old_deform.deform_sample_levels(vt, cs.LEVELS, loc, weights)

        def new():
            return KD.deform_sample_levels(vt, cs.LEVELS, loc, weights)

        _agree(f"K1 {dtype}", old, new, KD.deform_sample_levels_plain(vt, cs.LEVELS, loc, weights),
               cs.K1_TOL[dtype])
        same = torch.equal(old(), new())
        widened = torch.equal(new(), KD.deform_sample_levels(vt.float(), cs.LEVELS, loc, weights))
        cs.log(f"ab K1 {dtype}: old == new bit for bit: {same}; new == new f32 route on V.float(): {widened}")
        rows.append(dict(kernel="K1", dtype=dtype, same_bits=same, equals_f32_route=widened,
                         **ab(f"K1 one encoder layer, 3 levels, {dtype} V, B={cs.TRAIN_B}", old, new)))
    for nk in cs.KEYS:
        q, k, v, m, ab_ = cs.mca_inputs(rng, nk, dev, cs.TRAIN_B)
        for dt in (torch.float32, torch.bfloat16):
            qd, kd, vd = (t.to(dt) for t in (q, k, v))
            dtype = str(dt).replace("torch.", "")

            def old():
                return old_mca.masked_cross_attention(qd, kd, vd, m, ab_)

            def new():
                return KM.masked_cross_attention(qd, kd, vd, m, ab_)

            ref = KM.masked_cross_attention_plain(qd, kd, vd, m, ab_).float()
            _agree(f"K3 K={nk} {dtype}", lambda: old().float(), lambda: new().float(), ref,
                   cs.K3_TOL if dt == torch.float32 else cs.K3_TOL_BF16)
            same = torch.equal(old(), new())
            cs.log(f"ab K3 K={nk} {dtype}: old == new bit for bit: {same}")
            rows.append(dict(kernel="K3", dtype=dtype, same_bits=same,
                             **ab(f"K3 K={nk} {dtype} B={cs.TRAIN_B}", old, new)))
    torch.cuda.synchronize()
    return rows


def trace(parent_kernels) -> dict:
    """What each commit's kernels compiled to: per instantiation the registers,
    stack frame and static shared memory the binary records (`cuobjdump
    -res-usage`), and its SASS's local-memory (LDL, STL) and tensor-core
    (HMMA, by kind) instructions."""
    from rgbdseg_torch.ops import kernels as K

    report = {}
    for label, mod in (("old", parent_kernels), ("new", K)):
        source_of = getattr(mod, "_source", lambda name: name)  # entry points sharing a source: one library
        for name in dict.fromkeys(map(source_of, mod._SIGNATURES)):
            lib = mod._target(name)
            usage, sass = res_usage(lib), sass_counts(lib)
            for fn, res in usage.items():
                cs.log(f"trace {label} {name}: {fn}: {res}; SASS {sass.get(fn)}")
            report[f"{label} {name}"] = {"res_usage": usage, "sass": sass}
    return report


def _cuobjdump(*args) -> str:
    tool = shutil.which("cuobjdump") or str(Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "cuobjdump")
    return subprocess.run([tool, *args], capture_output=True, text=True, check=True).stdout


def res_usage(lib: Path) -> dict:
    """{kernel: "REG:n STACK:n SHARED:n LOCAL:n ..."} from `cuobjdump -res-usage`."""
    from rgbdseg_torch.ops.kernels import _demangle

    usage, fn = {}, None
    for ln in _cuobjdump("-res-usage", str(lib)).splitlines():
        if "Function " in ln:
            fn = ln.split("Function ")[-1].strip().rstrip(":")
        elif fn is not None and "REG:" in ln:
            usage[fn] = " ".join(ln.split())
            fn = None
    names = _demangle(list(usage))
    return {names[k]: v for k, v in usage.items()}


def sass_counts(lib: Path) -> dict:
    """{kernel: {"LDL": n, "STL": n, "HMMA.<shape>.<types>": n, "RED.<kind>": n, ...}}
    from `cuobjdump -sass` of a built library: local-memory instructions, the
    tensor-core instructions by kind (TF32 or BF16 operands) and the atomics
    by kind (RED, REDG, ATOM, ATOMG in device memory, ATOMS in shared memory;
    not a barrier's BAR.RED)."""
    from rgbdseg_torch.ops.kernels import _demangle

    counts, fn = {}, None
    for ln in _cuobjdump("-sass", str(lib)).splitlines():
        if "Function :" in ln:
            fn = ln.split("Function :")[-1].strip()
            counts[fn] = {"LDL": 0, "STL": 0}
        elif fn is not None:
            m = re.search(r"\b(LDL|STL|HMMA\.[\w.]+|(?<!BAR\.)(?:REDG?|ATOM[GS]?)\.[\w.]+)", ln)
            if m:
                counts[fn][m.group(1)] = counts[fn].get(m.group(1), 0) + 1
    names = _demangle(list(counts))
    return {names[k]: v for k, v in counts.items()}


if __name__ == "__main__":
    sys.exit(main())
