"""Time the port's CUDA kernels against an earlier commit's, in one process on one card.

    python3 kernel_ab.py --parent DIR [--seed N] [--requests N]

DIR is a checkout of the earlier commit (e.g. `git archive <commit>` unpacked
into `build/parent`). Its package is imported under another name and builds
its own sources into `DIR/build/kernels`. Every kernel is timed at main-path
shapes in the order old, new, new, old, both as device time (a replayed CUDA
graph) and as eager time per call from Python (see `chip_smoke.py`), and both
are held against the plain version first. Sections, each run where the parent
has what it needs (else it says so and is skipped):

- forward, for a parent from the first slice of the port (its
  `ops.kernels.deformable` has `deform_sample_level`, one K1 launch per level
  on per-level pixel coordinates, and no `deform_sample_levels`): K1 and K3 at
  the shapes of a 480x640 0.4.0 request, K1 at the in-model sampling geometry.
  The old K1 time is one encoder layer's three per-level calls on inputs laid
  out beforehand, and separately the old call site, which also lays them out
  (permutes, copies, the sum over levels); the new time is the one call an
  encoder layer makes now.
- backward, for a parent with backward kernels (`_launch_bwd` in both kernel
  modules, the third slice's signatures): the launch each autograd backward
  makes, at the train shapes (B=2): K1 at the in-model and the "spread"
  geometries (`chip_smoke.k1_inputs`), K3 at K = 300, 1200 and 4800 on the
  log-sum-exp of this tree's forward.
- requests: both commits' full-width 0.4.0 models, with the same seeded
  weights, serve the same 480x640 frame in turns old, new, new, old
  (`--requests` rounds): median request ms of each, and their logits'
  difference.
- train steps, for a parent with `train.trainer.train_step`: both commits'
  full-width models, with the same seeded weights, take `chip_smoke.py`
  phase 6's train step (batch 2 of 480x640 float stacks, 16 box slots) in
  turns old, new, new, old (`--requests` rounds): median step ms of each.

Prints one line per shape and a JSON line; needs one CUDA card.

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
    train shapes, each held against the plain backward first."""
    import torch

    from rgbdseg_torch.ops.kernels import deformable as KD
    from rgbdseg_torch.ops.kernels import masked_attention as KM

    dev = torch.device("cuda")
    rows = []
    starts = [sum(h * w for h, w in cs.LEVELS[:i]) for i in range(len(cs.LEVELS))]
    for geometry in ("model", "spread"):
        value, loc, weights = cs.k1_inputs(rng, dev, geometry, cs.TRAIN_B)
        g = torch.from_numpy(rng.randn(cs.TRAIN_B, cs.L, cs.NH * cs.HD).astype(np.float32)).to(dev)

        def old():
            return old_deform._launch_bwd(value, loc, weights, cs.LEVELS, starts, True, g)

        def new():
            return KD._launch_bwd(value, loc, weights, cs.LEVELS, starts, True, g)

        ref = KD.deform_sample_levels_plain_bwd(value, cs.LEVELS, loc, weights, g)
        for label, fn in (("old", old), ("new", new)):
            cs._check_grads(f"ab K1-bwd {geometry} {label}", fn(), ref, cs.K1_BWD_RTOL)
        rows.append(dict(kernel="K1-bwd", **ab(f"K1-bwd one encoder layer, {geometry} geometry, B={cs.TRAIN_B}",
                                                 old, new)))
    for nk in cs.KEYS:
        q, k, v, m, ab_ = cs.mca_inputs(rng, nk, dev, cs.TRAIN_B)
        g = torch.from_numpy(rng.randn(*q.shape).astype(np.float32)).to(dev)
        out, lse = KM._launch(q, k, v, m, ab_)

        def old():
            return old_mca._launch_bwd(q, k, v, m, ab_, out, lse, g)

        def new():
            return KM._launch_bwd(q, k, v, m, ab_, out, lse, g)

        ref = KM.masked_cross_attention_plain_bwd(q, k, v, m, ab_, g)
        for label, fn in (("old", old), ("new", new)):
            cs._check_grads(f"ab K3-bwd K={nk} {label}", fn(), ref, cs.K3_BWD_RTOL, joint=True)
        rows.append(dict(kernel="K3-bwd", **ab(f"K3-bwd K={nk} B={cs.TRAIN_B}", old, new)))
    torch.cuda.synchronize()
    return rows


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
    ap.add_argument("--parent", type=Path, required=True, help="checkout of the earlier commit")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--requests", type=int, default=10,
                    help="timed rounds of old/new/new/old requests, and of train steps")
    ap.add_argument("--parallel", action="store_true",
                    help="instead: chip_smoke.py phase 18 of the parent and of this tree in turns")
    ap.add_argument("--phase18-of", type=Path, default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
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
    cs.log(f"device: {smi}; parent {args.parent}; TF32 off")
    build_all()
    old_deform, old_mca, old_predictor = load_parent(args.parent.resolve())
    rng = np.random.RandomState(args.seed)
    rows = []
    if all(hasattr(mod, "_launch_bwd") for mod in (old_deform, old_mca)):
        rows += backward_ab(old_deform, old_mca, rng)
    else:
        cs.log("ab: the parent has no backward kernels; backward section skipped")
    if hasattr(old_deform, "deform_sample_levels"):
        cs.log("ab: the parent already has the one-launch K1 forward; forward section skipped")
    else:
        rows += forward_ab(old_deform, old_mca, rng)
    torch.cuda.synchronize()
    e2e = requests_ab(old_predictor, args.seed, rng, args.requests)
    steps = None
    if hasattr(importlib.import_module("parent_rgbdseg_torch.train.trainer"), "train_step"):
        steps = train_ab(args.seed, rng, args.requests)
    else:
        cs.log("ab: the parent has no train step; train section skipped")
    print(json.dumps({"device": smi, "ab": rows, "requests": e2e, "train_steps": steps}))
    return 0


def forward_ab(old_deform, old_mca, rng) -> list[dict]:
    """The forward section, against a parent from the first slice of the port."""
    import torch

    from rgbdseg_torch.ops.kernels.deformable import deform_sample_levels, deform_sample_levels_plain
    from rgbdseg_torch.ops.kernels.masked_attention import masked_cross_attention, masked_cross_attention_plain

    rows = []
    value, loc, weights = cs.k1_inputs(rng, torch.device("cuda"), "model")
    levels = [cs.k1_level(value, loc, weights, lvl) for lvl in range(len(cs.LEVELS))]

    def old_kernels():  # one encoder layer's three per-level calls, inputs laid out beforehand
        return [old_deform.deform_sample_level(*lv, h, w) for (h, w), lv in zip(cs.LEVELS, levels)]

    def old_call_site():  # the earlier DeformableAttention body around the kernel
        out = torch.zeros(1, cs.NH, cs.L, cs.HD, device="cuda")
        start = 0
        wt = weights.permute(0, 2, 1, 3, 4)
        for lvl, (h, w) in enumerate(cs.LEVELS):
            vbh = value[:, start : start + h * w].permute(0, 2, 1, 3).reshape(cs.NH, h * w, cs.HD).contiguous()
            coords = loc[:, :, :, lvl].permute(0, 2, 1, 3, 4).reshape(cs.NH, cs.L, cs.P, 2)
            gx = (coords[..., 0] * w - 0.5).contiguous()
            gy = (coords[..., 1] * h - 0.5).contiguous()
            aw = wt[:, :, :, lvl].reshape(cs.NH, cs.L, cs.P).float().contiguous()
            sampled = old_deform.deform_sample_level(gx, gy, aw, vbh, h, w)
            out = out + sampled.reshape(1, cs.NH, cs.L, cs.HD)
            start += h * w
        return out.permute(0, 2, 1, 3).reshape(1, cs.L, cs.NH * cs.HD)

    def new():
        return deform_sample_levels(value, cs.LEVELS, loc, weights)

    _agree("K1", old_call_site, new, deform_sample_levels_plain(value, cs.LEVELS, loc, weights), cs.K1_TOL["float32"])
    rows.append(dict(kernel="K1", **ab("K1 one encoder layer, 3 levels (old: 3 calls)", old_kernels, new)))
    rows.append(dict(kernel="K1", **ab("K1 one encoder layer, old call site with its layout ops", old_call_site, new)))

    for nk in cs.KEYS:
        q, k, v, m, ab_ = cs.mca_inputs(rng, nk, torch.device("cuda"))

        def old_k3():
            return old_mca.masked_cross_attention(q, k, v, m, ab_)

        def new_k3():
            return masked_cross_attention(q, k, v, m, ab_)

        _agree(f"K3 K={nk}", old_k3, new_k3, masked_cross_attention_plain(q, k, v, m, ab_), cs.K3_TOL)
        rows.append(dict(kernel="K3", **ab(f"K3 K={nk}", old_k3, new_k3)))
    return rows


if __name__ == "__main__":
    sys.exit(main())
