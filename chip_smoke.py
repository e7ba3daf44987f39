"""Drive the PyTorch port (`rgbdseg_torch`) on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--seed N]

Phases, one line of numbers each; any failure raises and the exit code is not 0:
  1. device: the card's name and power limit (nvidia-smi); TF32 off for
     matmuls and convolutions, so the float32 comparisons below mean something;
  2. build: nvcc compiles every kernel under rgbdseg_torch/csrc/, in parallel;
  3. kernels: each CUDA kernel against its plain PyTorch version at the
     480x640 main-path shapes, with its device time, the plain version's and
     one PyTorch library call's (CUDA events around a replayed CUDA graph of
     many calls), and its eager time per call from Python. K1 is timed at
     the in-model sampling geometry (each query samples 1..4 pixels from its
     reference point along its head's direction, uniform attention weights, as
     the seeded model has them): all levels in one launch, as an encoder layer
     calls it, and each level alone through the per-level entry; uniform random
     coordinates, out of bounds too, are a correctness case only;
  4. slice: the full-width 0.4.0 model (Swin-T, 6 deformable encoder layers,
     100 queries, 10 prediction points, 40 labels; seeded random weights)
     answers 3 requests of synthetic 480x640 10-channel frames through
     `Predictor.predict_pixels`; the kernels' launch counts must show every
     request went through them (6 K1, one per encoder layer; 9 K3); then one
     frame through a CPU copy of the same model, where the plain versions run,
     bounds the logits' difference;
  5. backward kernels: K1's and K3's backward kernels, reached through their
     autograd wrappers (`torch.autograd.grad` of `deform_sample_levels` and
     `masked_cross_attention`, one forward and one backward launch each),
     against their plain backward versions at the train shapes (B=2): K1 at the
     in-model geometry (the headline time), at the in-model layout with offsets
     of +-12 pixels ("spread") and at random coordinates (both correctness
     cases, timed too), K3 at K=300, 1200 and 4800 with an all-blocked row, and
     a second K3 launch that must give the same bits; the device time of the
     backward launch, the
     plain backward's and the library yardstick's (the aten grid_sample backward
     for each level; SDPA's forward and backward less its forward), each from a
     replayed CUDA graph, the eager time, and a byte and operation bound;
  6. train: 3 optimizer steps (`train_step`) of the full-width 0.4.0 model with
     drop path 0.3, dropout and batch-statistics BatchNorm, on 2 synthetic
     480x640 frames with 16 box instances each, f32 with TF32 off; per step the
     step time, the matcher's host time, loss, gradient norm, peak device memory
     and the launches, which must be 6 K1 and 9 K3 forward and backward each;
     the kernels' gradients must reach value_proj, sampling_offsets,
     attention_weights and the decoder's q/k/v projections;
  7. step 0 on GPU and CPU: the same weights and batch, the same injected point
     coordinates, dropout and drop path off: the loss, the gradient norm and the
     gradients of the kernel-fed parameters agree, with the CPU on its own
     decoder attention masks and, to a tighter limit, on the GPU's;
  8. a `kernels` JSON line; the last line is the device JSON.
With --profile, phases 4 and 6 also profile one request and one train step
(torch.profiler): the device's busy share and the kernels that take the most
device time.
It needs one CUDA card and a checkout of the repository around it; without
either it exits with code 1 and prints no result.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
F32_FLOP_PER_S = 67e12  # float32 outside the tensor cores
# K3 computes its float32 products on the tensor cores as three TF32 products
# each (495 TFLOP/s dense TF32), so its float32 work runs at a third of that.
F32_AS_3XTF32_FLOP_PER_S = 495e12 / 3
K1_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
K3_TOL, K3_TOL_BF16 = 1e-5, 2e-2
# CPU vs GPU logits of the whole model, relative to the largest |logit|: both
# run float32 with TF32 off, so they differ only by summation order (cuDNN and
# cuBLAS vs the CPU's kernels, the CUDA kernels vs their plain versions), about
# 1e-6 per op over ~40 stacked layers.
SLICE_RTOL = 1e-3
# Backward kernels against their plain versions, relative to the largest |ref|:
# K1 per gradient (its d value is summed with float atomics in an order that
# changes from run to run, a few ulps of the largest contribution); K3 over
# d q, d k and d v together (with one key, d q and d k are exactly 0 in the
# plain version).
K1_BWD_RTOL = K3_BWD_RTOL = 1e-5
TRAIN_B, TRAIN_T = 2, 16  # train batch and real instances per frame
# Step 0 on GPU against CPU, relative (loss, gradient norm, worst kernel-fed
# gradient leaf against its own max): f32 with TF32 off on both, so with the
# same decoder attention masks they differ only by summation orders (cuDNN,
# cuBLAS, K1's atomics against the CPU). Measured on the H100 at seed 0: 2.4e-7,
# 1.3e-5, 2.4e-4 (the last decoder layer's q projection; the rest 5e-6..1.5e-4).
# On its own masks the CPU may also flip the blocked test of a mask pixel whose
# logit sits at 0 (1 entry at seed 0, the same readings), which moves later
# layers: ten times the slack.
STEP0_SAME_RTOL = (1e-5, 1e-4, 1e-3)
STEP0_OWN_RTOL = (1e-4, 1e-3, 1e-2)
LEVELS = ((15, 20), (30, 40), (60, 80))  # deformable levels at 480x640
KEYS = (300, 1200, 4800)  # masked cross-attention keys at 480x640
NH, L, P, HD, NQ = 8, 6300, 4, 32, 100  # heads, queries (all levels' pixels), points


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, iters: int = 50) -> float:
    """Device ms per call: `iters` calls captured in one CUDA graph and replayed
    after a warm-up, so the host's launch overhead stays out of the number."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def eager_ms(fn, iters: int = 50) -> float:
    """Wall ms per call of `iters` calls issued from Python, ending in a
    synchronise: the kernel or the host's dispatch, whichever is slower."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t) * 1e3 / iters


def _timed(fn):
    """(fn(), wall ms) with the device synchronised on both sides."""
    import torch

    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t) * 1e3


def bound_ms(nbytes: float, flops: float, flop_rate: float = F32_FLOP_PER_S) -> tuple[float, str]:
    tb, tf = nbytes / HBM_BYTES_PER_S * 1e3, flops / flop_rate * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def k1_inputs(rng, dev, geometry: str, b: int = 1):
    """Multi-level K1 inputs at 480x640 in the model's layouts: value (b, 6300, 8, 32),
    locations (b, 6300, 8, 3, 4, 2), weights (b, 6300, 8, 3, 4). "model": the
    in-model geometry with uniform weights; "spread": the in-model layout
    (reference points) with offsets uniform in +-12 pixels at each level, so
    neighbouring queries share fewer cells (a correctness case, timed too);
    "random": uniform
    locations over [-0.1, 1.1]^2 and random softmax weights (a correctness case)."""
    import torch

    from rgbdseg_torch.models.pixel_decoder import initial_locations, reference_points_for_shapes, sampling_locations

    value = torch.from_numpy(rng.randn(b, L, NH, HD).astype(np.float32)).to(dev)
    if geometry == "model":
        loc = initial_locations(LEVELS, NH, P, dev).expand(b, -1, -1, -1, -1, -1).contiguous()
        weights = torch.full((b, L, NH, len(LEVELS), P), 1.0 / (len(LEVELS) * P), device=dev)
    elif geometry == "spread":
        ref = reference_points_for_shapes(LEVELS, dev)[None, :, None, :].expand(b, -1, len(LEVELS), 2)
        off = torch.from_numpy(rng.uniform(-12, 12, (b, L, NH, len(LEVELS), P, 2)).astype(np.float32)).to(dev)
        loc = sampling_locations(ref, off, LEVELS).contiguous()
        weights = torch.full((b, L, NH, len(LEVELS), P), 1.0 / (len(LEVELS) * P), device=dev)
    else:
        loc = torch.from_numpy(rng.uniform(-0.1, 1.1, (b, L, NH, len(LEVELS), P, 2)).astype(np.float32)).to(dev)
        weights = torch.softmax(torch.from_numpy(rng.randn(b, L, NH, len(LEVELS) * P).astype(np.float32)), -1)
        weights = weights.reshape(b, L, NH, len(LEVELS), P).to(dev)
    return value, loc, weights


def k1_level(value, loc, weights, lvl):
    """One level of multi-level inputs in the JAX per-level layout: gx, gy, aw, v."""
    h, w = LEVELS[lvl]
    start = sum(a * b for a, b in LEVELS[:lvl])
    v = value[:, start : start + h * w].permute(0, 2, 1, 3).reshape(NH, h * w, HD).contiguous()
    coords = loc[:, :, :, lvl].permute(0, 2, 1, 3, 4).reshape(NH, L, P, 2)
    aw = weights[:, :, :, lvl].permute(0, 2, 1, 3).reshape(NH, L, P).contiguous()
    return (coords[..., 0] * w - 0.5).contiguous(), (coords[..., 1] * h - 0.5).contiguous(), aw, v


def k1_corners(gx, gy, aw, h, w) -> int:
    """Bilinear corners one level's data needs: in bounds and of non-zero weight."""
    x0, y0 = gx.floor(), gy.floor()
    fx, fy = gx - x0, gy - y0
    n = 0
    for dy in (0, 1):
        for dx in (0, 1):
            inb = (x0 + dx >= 0) & (x0 + dx <= w - 1) & (y0 + dy >= 0) & (y0 + dy <= h - 1)
            wgt = aw * (fy if dy else 1 - fy) * (fx if dx else 1 - fx)
            n += (inb & (wgt != 0)).sum().item()
    return n


def k1_bwd_cells(loc) -> int:
    """(point, cell) pairs the K1 backward needs: in bounds, with a non-zero
    tent value or slope in either direction."""
    from rgbdseg_torch.ops.kernels.deformable import _OFFSETS, _tent_factors

    n = 0
    for lvl, (h, w) in enumerate(LEVELS):
        x0, wx, dx = _tent_factors(loc[:, :, :, lvl, :, 0] * w - 0.5)
        y0, wy, dy = _tent_factors(loc[:, :, :, lvl, :, 1] * h - 0.5)
        for iy, oy in enumerate(_OFFSETS):
            for ix, ox in enumerate(_OFFSETS):
                inb = (x0 + ox >= 0) & (x0 + ox <= w - 1) & (y0 + oy >= 0) & (y0 + oy <= h - 1)
                nz = (wy[iy] * wx[ix] != 0) | (wy[iy] * dx[ix] != 0) | (dy[iy] * wx[ix] != 0)
                n += (inb & nz).sum().item()
    return n


def mca_inputs(rng, nk, dev, b: int = 1):
    import torch

    q = rng.randn(b, 8, NQ, HD).astype(np.float32) * HD**-0.5
    k = rng.randn(b, 8, nk, HD).astype(np.float32)
    v = rng.randn(b, 8, nk, HD).astype(np.float32)
    m = rng.randn(b, NQ, nk).astype(np.float32)
    m[:, 0] = -np.abs(m[:, 0]) - 0.1  # an all-blocked row: exempted, attends to every key
    ab = np.all(m < 0.0, axis=-1)
    assert ab[0, 0]
    return [torch.from_numpy(x).to(dev) for x in (q, k, v, m, ab)]


def _check(name, got, ref, tol):
    err = (got - ref).abs().max().item()
    log(f"kernel {name}: max_abs_err {err:.3e} (tol {tol:g})")
    if not err <= tol:
        raise AssertionError(f"{name}: {err} > {tol}")
    return err


def _check_grads(name, got, ref, rtol, joint=False):
    """Each gradient within rtol x its largest |ref| (or, with `joint`, the largest
    over all of them); returns the largest absolute error."""
    scales = [r.abs().max().item() for r in ref]
    return max(_check(f"{name} d{i}", g, r, rtol * (max(scales) if joint else s))
               for i, (g, r, s) in enumerate(zip(got, ref, scales)))


def check_kernels(rng, dev) -> dict:
    """Phase 3: every kernel against its plain version at the main-path shapes."""
    import torch
    import torch.nn.functional as F

    from rgbdseg_torch.ops.kernels.deformable import (
        deform_sample_level,
        deform_sample_level_plain,
        deform_sample_levels,
        deform_sample_levels_plain,
    )
    from rgbdseg_torch.ops.kernels.masked_attention import (
        masked_cross_attention,
        masked_cross_attention_plain,
    )

    rows = {"deform_sample_levels": [], "deform_sample_level": [], "masked_cross_attention": []}
    for geometry in ("random", "model"):
        value, loc, weights = k1_inputs(rng, dev, geometry)
        errs = [
            _check(f"deform_sample_levels {geometry} v={str(vt.dtype)[6:]}",
                   deform_sample_levels(vt, LEVELS, loc, weights),
                   deform_sample_levels_plain(vt, LEVELS, loc, weights), K1_TOL[str(vt.dtype)[6:]])
            for vt in (value, value.bfloat16())
        ]
        levels = [k1_level(value, loc, weights, lvl) for lvl in range(len(LEVELS))]
        for (h, w), (gx, gy, aw, v) in zip(LEVELS, levels):
            for vt in (v, v.bfloat16()):
                dt = str(vt.dtype)[6:]
                errs.append(_check(f"deform_sample_level {geometry} {h}x{w} v={dt}",
                                   deform_sample_level(gx, gy, aw, vt, h, w),
                                   deform_sample_level_plain(gx, gy, aw, vt, h, w), K1_TOL[dt]))
        if geometry != "model":
            continue

        # Timed at the in-model geometry. The library call: grid_sample per level on
        # images laid out for it beforehand, and the weighted sums.
        imgs = [v.reshape(NH, h, w, HD).permute(0, 3, 1, 2).contiguous() for (h, w), (_, _, _, v) in zip(LEVELS, levels)]
        grids = [torch.stack([(gx + 0.5) / w * 2 - 1, (gy + 0.5) / h * 2 - 1], dim=-1)
                 for (h, w), (gx, gy, _, _) in zip(LEVELS, levels)]

        def level_library(i):
            s = F.grid_sample(imgs[i], grids[i], mode="bilinear", padding_mode="zeros", align_corners=False)
            return torch.einsum("bdlp,blp->bld", s, levels[i][2])

        def library():
            return sum(level_library(i) for i in range(len(LEVELS)))

        ref = deform_sample_levels_plain(value, LEVELS, loc, weights).reshape(L, NH, HD).transpose(0, 1)
        lib_err = (library() - ref).abs().max().item()
        if not lib_err <= 1e-3:
            raise AssertionError(f"grid_sample yardstick disagrees: {lib_err}")
        out_bytes = L * NH * HD * 4
        corners = [k1_corners(gx, gy, aw, h, w) for (h, w), (gx, gy, aw, _) in zip(LEVELS, levels)]
        # Each input read once, the output written once; one multiply-add per
        # head channel for each corner the data needs.
        nbytes = (value.numel() + loc.numel() + weights.numel()) * 4 + out_bytes
        b_ms, b_by = bound_ms(nbytes, sum(corners) * HD * 2)
        row = dict(
            shape="all levels", err=max(errs[:2]),
            ms=time_ms(lambda: deform_sample_levels(value, LEVELS, loc, weights)),
            eager_ms=eager_ms(lambda: deform_sample_levels(value, LEVELS, loc, weights)),
            plain_ms=time_ms(lambda: deform_sample_levels_plain(value, LEVELS, loc, weights), 10),
            library_ms=time_ms(library), bound_ms=b_ms, bound_by=b_by, bytes=nbytes, flops=sum(corners) * HD * 2,
        )
        rows["deform_sample_levels"].append(row)
        log(f"kernel deform_sample_levels in-model 3 levels f32: ms {row['ms']:.4f} eager_ms {row['eager_ms']:.4f} plain_ms {row['plain_ms']:.4f} "
            f"library_ms {row['library_ms']:.4f} bound_ms {b_ms:.4f} ({b_by}); grid_sample err {lib_err:.2e}")
        for i, ((h, w), (gx, gy, aw, v)) in enumerate(zip(LEVELS, levels)):
            nbytes = (3 * gx.numel() + v.numel()) * 4 + out_bytes
            b_ms, b_by = bound_ms(nbytes, corners[i] * HD * 2)
            row = dict(
                shape=f"{h}x{w}", err=max(errs[2 + 2 * i : 4 + 2 * i]),
                ms=time_ms(lambda: deform_sample_level(gx, gy, aw, v, h, w)),
                eager_ms=eager_ms(lambda: deform_sample_level(gx, gy, aw, v, h, w)),
                plain_ms=time_ms(lambda: deform_sample_level_plain(gx, gy, aw, v, h, w), 10),
                library_ms=time_ms(lambda: level_library(i)), bound_ms=b_ms, bound_by=b_by,
                bytes=nbytes, flops=corners[i] * HD * 2,
            )
            rows["deform_sample_level"].append(row)
            log(f"kernel deform_sample_level in-model {h}x{w} f32: ms {row['ms']:.4f} eager_ms {row['eager_ms']:.4f} plain_ms {row['plain_ms']:.4f} "
                f"library_ms {row['library_ms']:.4f} bound_ms {b_ms:.4f} ({b_by})")
    for nk in KEYS:
        q, k, v, m, ab = mca_inputs(rng, nk, dev)
        err = _check(f"masked_cross_attention K={nk}", masked_cross_attention(q, k, v, m, ab),
                     masked_cross_attention_plain(q, k, v, m, ab), K3_TOL)
        qb, kb, vb = q.bfloat16(), k.bfloat16(), v.bfloat16()
        _check(f"masked_cross_attention K={nk} bf16", masked_cross_attention(qb, kb, vb, m, ab).float(),
               masked_cross_attention_plain(qb, kb, vb, m, ab).float(), K3_TOL_BF16)
        allowed = ~((m < 0) & ~ab[:, :, None])[:, None]

        def library():
            return F.scaled_dot_product_attention(q, k, v, attn_mask=allowed, scale=1.0)

        lib_err = (library() - masked_cross_attention_plain(q, k, v, m, ab)).abs().max().item()
        if not lib_err <= 1e-4:
            raise AssertionError(f"SDPA yardstick disagrees: {lib_err}")
        nbytes = (q.numel() * 2 + k.numel() + v.numel()) * 4 + m.numel() * 4 + ab.numel()
        # q.k and p.v multiply-adds for each unblocked (query, key) pair and head
        flops = 4 * q.shape[1] * HD * allowed.sum().item()
        b_ms, b_by = bound_ms(nbytes, flops, F32_AS_3XTF32_FLOP_PER_S)
        row = dict(
            shape=f"K={nk}", err=err,
            ms=time_ms(lambda: masked_cross_attention(q, k, v, m, ab)),
            eager_ms=eager_ms(lambda: masked_cross_attention(q, k, v, m, ab)),
            plain_ms=time_ms(lambda: masked_cross_attention_plain(q, k, v, m, ab)),
            library_ms=time_ms(library),
            bound_ms=b_ms, bound_by=b_by, bytes=nbytes, flops=flops, flop_rate=F32_AS_3XTF32_FLOP_PER_S,
        )
        rows["masked_cross_attention"].append(row)
        log(f"kernel masked_cross_attention K={nk}: ms {row['ms']:.4f} eager_ms {row['eager_ms']:.4f} plain_ms {row['plain_ms']:.4f} "
            f"library_ms {row['library_ms']:.4f} bound_ms {b_ms:.4f} ({b_by}); SDPA err {lib_err:.2e}")
    torch.cuda.synchronize()
    return rows


def check_backward_kernels(rng, dev) -> dict:
    """Phase 5: each backward kernel, reached through its autograd wrapper as the
    train step reaches it, against its plain backward at the train shapes."""
    import torch
    import torch.nn.functional as F

    from rgbdseg_torch.ops import kernels as K
    from rgbdseg_torch.ops.kernels import deformable as KD
    from rgbdseg_torch.ops.kernels import masked_attention as KM

    def autograd_grads(name, key, fn, inputs, g):
        """Gradients of fn(*leaves) through torch.autograd, and a check that the
        forward and the backward each launched their kernel once."""
        leaves = [t.detach().requires_grad_() for t in inputs]
        K.reset_launches()
        grads = torch.autograd.grad(fn(*leaves), leaves, g)
        if (K.LAUNCHES[key], K.LAUNCHES[f"{key}_bwd"]) != (1, 1):
            raise AssertionError(f"{name}: autograd launched {dict(K.LAUNCHES)}; expected one {key} and one {key}_bwd")
        return grads

    rows = {"deform_sample_levels_bwd": [], "masked_cross_attention_bwd": []}
    starts = [sum(h * w for h, w in LEVELS[:i]) for i in range(len(LEVELS))]
    for geometry in ("random", "spread", "model"):
        value, loc, weights = k1_inputs(rng, dev, geometry, TRAIN_B)
        g = torch.from_numpy(rng.randn(TRAIN_B, L, NH * HD).astype(np.float32)).to(dev)

        def plain():
            return KD.deform_sample_levels_plain_bwd(value, LEVELS, loc, weights, g)

        got = autograd_grads(f"deform_sample_levels_bwd {geometry}", "deformable",
                             lambda v, lc, w: KD.deform_sample_levels(v, LEVELS, lc, w), (value, loc, weights), g)
        err = _check_grads(f"deform_sample_levels_bwd {geometry}", got, plain(), K1_BWD_RTOL)

        def kernel():  # the launch the autograd backward makes, alone, for the CUDA graph
            return KD._launch_bwd(value, loc, weights, LEVELS, starts, True, g)

        if geometry != "model":  # correctness cases, timed too
            log(f"kernel deform_sample_levels_bwd {geometry} (correctness case) B={TRAIN_B}: ms {time_ms(kernel):.4f}; "
                f"{k1_bwd_cells(loc)} (point, cell) pairs")
            continue

        # The library yardstick: aten's grid_sample backward for each level, on
        # images, grids and output gradients laid out for it beforehand.
        lib_args = []
        for lvl, (h, w) in enumerate(LEVELS):
            img = value[:, starts[lvl] : starts[lvl] + h * w].permute(0, 2, 3, 1).reshape(TRAIN_B * NH, HD, h, w)
            grid = loc[:, :, :, lvl].permute(0, 2, 1, 3, 4).reshape(TRAIN_B * NH, L, P, 2) * 2 - 1
            go = torch.randn(TRAIN_B * NH, HD, L, P, device=dev)
            lib_args.append((go, img.contiguous(), grid.contiguous()))

        def library():
            return [torch.ops.aten.grid_sampler_2d_backward(go, img, grid, 0, 0, False, [True, True])
                    for go, img, grid in lib_args]

        cells = k1_bwd_cells(loc)
        # Inputs value, locations, weights, grad_out read once; d value, d
        # locations, d weights written once. Per needed (point, cell): the dot
        # with grad_out and the d value update, 2 flops per head channel each.
        nbytes = 2 * (value.numel() + loc.numel() + weights.numel()) * 4 + g.numel() * 4
        flops = cells * HD * 4
        b_ms, b_by = bound_ms(nbytes, flops)
        row = dict(shape="all levels", err=err, ms=time_ms(kernel), eager_ms=eager_ms(kernel),
                   plain_ms=time_ms(plain, 10), library_ms=time_ms(library), bound_ms=b_ms, bound_by=b_by,
                   bytes=nbytes, flops=flops)
        rows["deform_sample_levels_bwd"].append(row)
        log(f"kernel deform_sample_levels_bwd in-model 3 levels B={TRAIN_B}: ms {row['ms']:.4f} eager_ms "
            f"{row['eager_ms']:.4f} plain_ms {row['plain_ms']:.4f} library_ms {row['library_ms']:.4f} "
            f"bound_ms {b_ms:.4f} ({b_by}); {cells} (point, cell) pairs")
    for nk in KEYS:
        q, k, v, m, ab = mca_inputs(rng, nk, dev, TRAIN_B)
        g = torch.from_numpy(rng.randn(*q.shape).astype(np.float32)).to(dev)

        def plain():
            return KM.masked_cross_attention_plain_bwd(q, k, v, m, ab, g)

        ref = plain()
        got = autograd_grads(f"masked_cross_attention_bwd K={nk}", "masked_attention",
                             lambda q_, k_, v_: KM.masked_cross_attention(q_, k_, v_, m, ab), (q, k, v), g)
        err = _check_grads(f"masked_cross_attention_bwd K={nk}", got, ref, K3_BWD_RTOL, joint=True)
        again = autograd_grads(f"masked_cross_attention_bwd K={nk}", "masked_attention",
                               lambda q_, k_, v_: KM.masked_cross_attention(q_, k_, v_, m, ab), (q, k, v), g)
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"masked_cross_attention_bwd K={nk}: two launches give different bits")
        log(f"kernel masked_cross_attention_bwd K={nk}: two launches give the same bits")
        out, lse = KM._launch(q, k, v, m, ab)

        def kernel():  # the launch the autograd backward makes, alone, for the CUDA graph
            return KM._launch_bwd(q, k, v, m, ab, out, lse, g)

        allowed = ~((m < 0) & ~ab[:, :, None])[:, None]
        qkv = [t.detach().requires_grad_() for t in (q, k, v)]

        def library_fwd():
            return F.scaled_dot_product_attention(*qkv, attn_mask=allowed, scale=1.0)

        def library():
            return torch.autograd.grad(library_fwd(), qkv, g)

        scale = max(r.abs().max().item() for r in ref)
        lib_err = max((a - r).abs().max().item() for a, r in zip(library(), ref))
        if not lib_err <= 1e-4 * scale:
            raise AssertionError(f"SDPA backward yardstick disagrees: {lib_err}")
        # Read q, k, v, out, d out, the mask, all_blocked and lse; write d q, d k, d v.
        nbytes = (2 * (q.numel() + k.numel() + v.numel()) + 2 * q.numel() + m.numel() + lse.numel()) * 4 + ab.numel()
        # S, dV, dP, dK, dQ: 5 multiply-adds per head channel for each unblocked
        # (query, key) pair and head; float32-accurate products, which the card
        # does fastest as three TF32 products each (as the K3 forward does).
        flops = 10 * q.shape[1] * HD * allowed.sum().item()
        b_ms, b_by = bound_ms(nbytes, flops, F32_AS_3XTF32_FLOP_PER_S)
        # SDPA's backward alone: its forward and backward in one graph, less its forward.
        lib_fwd_bwd_ms, lib_fwd_ms = time_ms(library, 20), time_ms(library_fwd, 20)
        row = dict(shape=f"K={nk}", err=err, ms=time_ms(kernel), eager_ms=eager_ms(kernel),
                   plain_ms=time_ms(plain, 10), library_ms=lib_fwd_bwd_ms - lib_fwd_ms,
                   bound_ms=b_ms, bound_by=b_by, bytes=nbytes, flops=flops, flop_rate=F32_AS_3XTF32_FLOP_PER_S)
        rows["masked_cross_attention_bwd"].append(row)
        log(f"kernel masked_cross_attention_bwd K={nk} B={TRAIN_B}: ms {row['ms']:.4f} eager_ms {row['eager_ms']:.4f} "
            f"plain_ms {row['plain_ms']:.4f} library_ms {row['library_ms']:.4f} (SDPA forward and backward "
            f"{lib_fwd_bwd_ms:.4f} less forward {lib_fwd_ms:.4f}) bound_ms {b_ms:.4f} ({b_by}); "
            f"SDPA backward err {lib_err:.2e}")
    torch.cuda.synchronize()
    return rows


def _sobel_mag(d: np.ndarray) -> np.ndarray:
    p = np.pad(d, 1, mode="reflect")
    gx = (p[:-2, 2:] + 2 * p[1:-1, 2:] + p[2:, 2:]) - (p[:-2, :-2] + 2 * p[1:-1, :-2] + p[2:, :-2])
    gy = (p[2:, :-2] + 2 * p[2:, 1:-1] + p[2:, 2:]) - (p[:-2, :-2] + 2 * p[:-2, 1:-1] + p[:-2, 2:])
    return np.sqrt(gx**2 + gy**2)


def synthetic_frame(rng, h: int = 480, w: int = 640, boxes: int = 4, with_masks: bool = False):
    """A 0.4.0 channel stack: normalised RGB, 3-channel normalised depth, the
    normalised Sobel magnitude of the depth (3 channels) and its validity mask.
    The depth is an 8-bit map (as a depth PNG is) of a background plane and
    `boxes` tilted planar boxes, so the DSAM histogram has clear modes. With
    `with_masks`, also the boxes' masks (boxes, h, w) float32, one instance each."""
    mean = np.array([0.485, 0.456, 0.406], np.float32)
    std = np.array([0.229, 0.224, 0.225], np.float32)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    depth = 200.0 - 0.05 * yy + rng.uniform(-0.02, 0.02) * xx
    masks = []
    for _ in range(boxes):
        y0, x0 = rng.randint(0, h * 3 // 4), rng.randint(0, w * 3 // 4)
        bh, bw = rng.randint(h // 8, h * 2 // 5), rng.randint(w // 8, w * 2 // 5)
        plane = rng.uniform(40, 160) + rng.uniform(-0.1, 0.1) * (yy - y0) + rng.uniform(-0.1, 0.1) * (xx - x0)
        box = (yy >= y0) & (yy < y0 + bh) & (xx >= x0) & (xx < x0 + bw)
        depth = np.where(box, plane, depth)
        masks.append(box)
    depth = np.clip(np.round(depth), 0, 255).astype(np.uint8)
    depth[rng.rand(h, w) < 0.01] = 0  # missing depth
    rgb = rng.randint(0, 256, (h, w, 3)).astype(np.float32)
    d = depth.astype(np.float32)
    mag = _sobel_mag(d)
    valid = d != 0
    mag[~valid] = 0
    gmask = mag > 0
    lo, hi = (mag[gmask].min(), mag.max()) if gmask.any() else (0.0, 0.0)
    norm = (mag - lo) / (hi - lo) if hi > lo else np.zeros_like(mag)
    norm[~gmask] = 0
    chans = [
        (rgb / 255.0 - mean) / std,
        (np.repeat(d[..., None], 3, -1) / 255.0 - mean) / std,
        np.repeat(norm[..., None], 3, -1),
        gmask[..., None],
    ]
    frame = np.concatenate(chans, axis=-1).astype(np.float32)
    return (frame, np.stack(masks).astype(np.float32)) if with_masks else frame


def profile_request(pred, frame, top: int = 15) -> None:
    """One request under torch.profiler (after a warm-up one)."""
    pred.predict_pixels(frame, threshold=0.0)
    profile_call("request", lambda: pred.predict_pixels(frame, threshold=0.0), top)


def profile_call(label: str, fn, top: int = 15) -> None:
    """One call of `fn` under torch.profiler: the device's busy share of the
    wall time and the kernels that take the most device time (profiler
    overhead included in the wall time)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, wall = _timed(fn)
    # Device-side events only (kernels and copies): the operators that launch
    # them report the same device time again, and the optimizer's annotation
    # spans its kernels on the device timeline.
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False) and not e.key.startswith("Optimizer.")]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    log(f"profile: {label} wall {wall:.2f} ms under the profiler, device busy {busy:.2f} ms "
        f"({100 * busy / wall:.1f}%), {sum(e.count for e in kernels)} device events")
    names = (r"deform_sample_bwd_kernel|deform_sample_kernel|mca_split_kernel|mca_combine_kernel|mca_bwd_dq_kernel"
             r"|mca_bwd_mask_kernel|mca_bwd_kernel")
    port = {m.group(0): e for e in kernels for m in [re.search(names, e.key)] if m}
    log(f"profile: port kernels {sum(e.self_device_time_total for e in port.values()) / 1e3:.3f} ms of device "
        "time: " + ", ".join(f"{k} {e.self_device_time_total / 1e3:.3f} ms {e.count}x" for k, e in port.items()))
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:top]:
        log(f"profile: {e.self_device_time_total / 1e3:8.3f} ms {e.count:5d}x  {e.key[:90]}")


def run_slice(seed: int, rng, profile: bool = False) -> dict:
    """Phase 4: the full-width 0.4.0 model serves 3 requests through the kernels."""
    import torch

    from rgbdseg_torch.config import ModelConfig
    from rgbdseg_torch.inference.postprocess import post_process_instance_segmentation
    from rgbdseg_torch.inference.predictor import Predictor
    from rgbdseg_torch.ops import kernels as K

    cfg = ModelConfig(num_labels=40, version="0.4.0")
    t0 = time.perf_counter()
    pred = Predictor(cfg, device="cuda", seed=seed)
    frames = [synthetic_frame(rng)[None] for _ in range(3)]
    log(f"slice: 0.4.0 full width, {sum(p.numel() for p in pred.model.parameters())} parameters, "
        f"built in {time.perf_counter() - t0:.1f} s")

    per_request = []
    torch.cuda.reset_peak_memory_stats()
    K.reset_launches()
    for i, frame in enumerate(frames):
        before = dict(K.LAUNCHES)
        res, ms = _timed(lambda: pred.predict_pixels(frame, threshold=0.0)[0])
        delta = {k: K.LAUNCHES[k] - before[k] for k in K.LAUNCHES}
        per_request.append(ms)
        log(f"slice request {i}: {ms:.2f} ms, {len(res['segments_info'])} segments, "
            f"masks {res['segmentation'].shape}, launches {delta}")
        if delta != {"deformable": 6, "masked_attention": 9, "deformable_bwd": 0, "masked_attention_bwd": 0}:
            raise AssertionError(f"request {i} launched {delta}; expected 6 deformable and 9 masked-attention")
    launches = dict(K.LAUNCHES)

    # Where a request's time goes: each stage synchronised, the median of 3.
    x0 = torch.from_numpy(frames[0]).to(pred.device)
    stages = {"pixel_level_module": [], "transformer_module": [], "post_process": []}
    with torch.no_grad():
        for _ in range(3):
            (mf, feats), t_pix = _timed(lambda: pred.model.pixel_level_module(x0))
            (cls, masks), t_dec = _timed(lambda: pred.model.transformer_module(feats, mf))
            _, t_post = _timed(lambda: post_process_instance_segmentation(
                cls[-1], masks[-1], threshold=0.0, target_sizes=[frames[0].shape[1:3]]))
            for k, t in zip(stages, (t_pix, t_dec, t_post)):
                stages[k].append(t)
    log("slice stages ms (median of 3): " + ", ".join(f"{k} {sorted(v)[1]:.2f}" for k, v in stages.items()))

    with torch.no_grad():
        cls_gpu, mask_gpu = (t.cpu() for t in pred._forward(x0))
        cpu = Predictor(cfg, state_dict={k: v.cpu() for k, v in pred.model.state_dict().items()}, device="cpu")
        t = time.perf_counter()
        cls_cpu, mask_cpu = cpu._forward(torch.from_numpy(frames[0]))
        cpu_s = time.perf_counter() - t
    for name, g in (("class", cls_gpu), ("mask", mask_gpu)):
        if not torch.isfinite(g).all():
            raise AssertionError(f"non-finite {name} logits on the GPU")
    if cls_gpu.shape != (1, 100, 41) or mask_gpu.shape != (1, 100, 120, 160):
        raise AssertionError(f"logit shapes {tuple(cls_gpu.shape)}, {tuple(mask_gpu.shape)}")
    for name, g, c in (("class", cls_gpu, cls_cpu), ("mask", mask_gpu, mask_cpu)):
        diff = (g - c).abs().max().item()
        scale = c.abs().max().item()
        log(f"slice {name} logits GPU vs CPU: max_abs_diff {diff:.3e}, max |logit| {scale:.3e}, "
            f"tol {SLICE_RTOL:g} x max(1, max |logit|)")
        if not diff <= SLICE_RTOL * max(1.0, scale):
            raise AssertionError(f"{name} logits GPU vs CPU differ by {diff}")
    log(f"slice: per-request ms {[round(x, 3) for x in per_request]}, CPU copy forward {cpu_s:.1f} s, "
        f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if profile:
        profile_request(pred, frames[0])
    return launches


def run_train(seed: int, rng, profile: bool = False):
    """Phase 6: 3 optimizer steps of the full-width 0.4.0 model through the kernels
    (and with `profile` a fourth under the profiler). Returns the launch counts
    of the 3 steps, the step-0 weights (on the CPU) and the batch."""
    import torch

    from rgbdseg_torch.config import ModelConfig
    from rgbdseg_torch.ops import kernels as K
    from rgbdseg_torch.ops import matcher
    from rgbdseg_torch.train.arguments import TrainingArguments
    from rgbdseg_torch.train.trainer import TrainBatch, build_training, train_step

    cfg = ModelConfig(num_labels=40, version="0.4.0")
    args = TrainingArguments(learning_rate=1e-4, weight_decay=0.05, per_device_train_batch_size=TRAIN_B)
    model, opt = build_training(cfg, args, num_examples=3 * TRAIN_B, seed=seed)
    step0 = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    frames, masks = zip(*(synthetic_frame(rng, boxes=TRAIN_T, with_masks=True) for _ in range(TRAIN_B)))
    classes = rng.randint(0, cfg.num_labels, (TRAIN_B, TRAIN_T))
    batch = TrainBatch(*(torch.from_numpy(np.ascontiguousarray(a)).to("cuda") for a in
                         (np.stack(frames), np.stack(masks), classes, np.ones((TRAIN_B, TRAIN_T), bool))))
    gen = torch.Generator(device="cuda").manual_seed(seed)
    expected = {"deformable": 6, "masked_attention": 9, "deformable_bwd": 6, "masked_attention_bwd": 9}
    torch.cuda.reset_peak_memory_stats()
    K.reset_launches()
    for step in range(3):
        before = dict(K.LAUNCHES)
        (loss, per_layer, gnorm), ms = _timed(lambda: train_step(model, opt, batch, gen))
        delta = {k: K.LAUNCHES[k] - before[k] for k in K.LAUNCHES}
        loss, gnorm = loss.item(), gnorm.item()
        log(f"train step {step}: {ms:.2f} ms, matcher host {matcher.STATS['solve_ms']:.2f} ms solve + "
            f"{matcher.STATS['copy_ms']:.2f} ms copy (waits for the forward), loss {loss:.6f}, grad norm "
            f"{gnorm:.6f}, final-layer losses {[round(v[-1].item(), 5) for v in per_layer.values()]}, "
            f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, launches {delta}")
        if not (np.isfinite(loss) and np.isfinite(gnorm)):
            raise AssertionError(f"step {step}: loss {loss}, grad norm {gnorm}")
        if delta != expected:
            raise AssertionError(f"step {step} launched {delta}; expected {expected}")
    attn = model.pixel_level_module.pixel_decoder.layer0.self_attn
    cross = model.transformer_module.layer0.cross_attn
    for name, mod in (("value_proj", attn.value_proj), ("sampling_offsets", attn.sampling_offsets),
                      ("attention_weights", attn.attention_weights), ("decoder q_proj", cross.q_proj),
                      ("decoder k_proj", cross.k_proj), ("decoder v_proj", cross.v_proj)):
        if mod.weight.grad is None or not mod.weight.grad.abs().sum().item() > 0:
            raise AssertionError(f"no gradient reached {name} through the kernels")
    log(f"train: {sum(p.numel() for p in model.parameters())} parameters, batch {TRAIN_B} x {TRAIN_T} instances; "
        "gradients reach value_proj, sampling_offsets, attention_weights and the decoder q/k/v projections")
    launches = dict(K.LAUNCHES)
    if profile:
        profile_call("train step", lambda: train_step(model, opt, batch, gen))
    return launches, step0, batch


def kernel_fed_leaves(cfg) -> list[str]:
    """Parameters whose gradients come straight out of the backward kernels: the
    first and last encoder layer's value, offset and weight projections (K1) and
    the first and last decoder layer's cross-attention q, k, v projections (K3).
    Not the key biases: the softmax cancels them, so their exact gradient is 0
    and both sides hold only rounding noise."""
    enc = [f"pixel_level_module.pixel_decoder.layer{i}.self_attn.{m}"
           for i in (0, cfg.encoder_layers - 1) for m in ("value_proj", "sampling_offsets", "attention_weights")]
    dec = [f"transformer_module.layer{i}.cross_attn.{m}"
           for i in (0, cfg.decoder_layers - 2) for m in ("q_proj", "k_proj", "v_proj")]
    return [f"{m}.{p}" for m in dict.fromkeys(enc + dec) for p in ("weight", "bias")
            if not (m.endswith("k_proj") and p == "bias")]


def step0_gpu_vs_cpu(state, batch) -> None:
    """Phase 7: one forward and backward from the step-0 weights on the GPU and on
    a CPU copy, dropout and drop path off, the same point coordinates injected
    into the criterion on both: loss, gradient norm, and the gradients of the
    kernel-fed parameters each against its own scale. The CPU runs twice: on its
    own decoder attention masks, and on the GPU's (substituted after each mask
    prediction), which shows how much of the difference the masks' sign flips
    at logit 0 make."""
    import torch

    from rgbdseg_torch.config import ModelConfig
    from rgbdseg_torch.models.mask2former import Mask2FormerRGBD
    from rgbdseg_torch.models.stochastic import Dropout
    from rgbdseg_torch.models.swin import SwinBlock
    from rgbdseg_torch.ops import losses
    from rgbdseg_torch.train.optim import global_norm

    cfg = ModelConfig(num_labels=40, version="0.4.0")
    leaves = kernel_fed_leaves(cfg)
    draws = {}

    def same_uniform(generator, shape):
        if tuple(shape) not in draws:
            draws[tuple(shape)] = torch.from_numpy(
                np.random.RandomState(len(draws)).uniform(0, 1, shape).astype(np.float32))
        return draws[tuple(shape)]

    def run(device, masks=None):
        """(loss, gradient norm, kernel-fed gradients, the decoder's attention masks
        as computed) of one forward and backward; with `masks`, each layer's
        attention mask is replaced by the given one."""
        model = Mask2FormerRGBD(cfg)
        model.load_state_dict(state, strict=True)
        model.to(device).train()
        for m in model.modules():
            if isinstance(m, Dropout):
                m.p = 0.0
            elif isinstance(m, SwinBlock):
                m.drop_path_rate = 0.0
        own = []

        def hook(module, inputs, output):
            pred, attn_mask = output
            own.append(tuple(t.cpu() for t in attn_mask))
            return None if masks is None else (pred, masks[len(own) - 1])

        model.transformer_module.mask_predictor.register_forward_hook(hook)
        b = [t.to(device) for t in batch]
        out = model(b[0])
        loss, _ = losses.mask2former_loss(cfg, out, *b[1:], None)
        loss.backward()
        norm = global_norm([p.grad for p in model.parameters() if p.grad is not None])
        params = dict(model.named_parameters())
        return loss.item(), norm.item(), {n: params[n].grad.cpu() for n in leaves}, own

    def compare(label, gpu, cpu):
        """Relative loss and norm differences, the worst kernel-fed leaf, and the
        attention-mask entries (of the 9 the decoder uses) whose blocked test differs."""
        flips = sum((((ga < 0) & ~gb[..., None]) != ((ca < 0) & ~cb[..., None])).sum().item()
                    for (ga, gb), (ca, cb) in zip(gpu[3][:-1], cpu[3][:-1]))
        # A leaf whose gradient is 0 on the CPU counts as infinitely far: the
        # kernel-fed leaves must all get one.
        leaf = {n: ((gpu[2][n] - c).abs().max() / c.abs().max()).nan_to_num(float("inf")).item()
                for n, c in cpu[2].items()}
        worst = max(leaf, key=leaf.get)
        dl, dn = abs(gpu[0] - cpu[0]) / abs(cpu[0]), abs(gpu[1] - cpu[1]) / abs(cpu[1])
        log(f"step0 GPU vs CPU {label}: loss {gpu[0]:.7f} / {cpu[0]:.7f} (rel {dl:.2e}), grad norm {gpu[1]:.7f} / "
            f"{cpu[1]:.7f} (rel {dn:.2e}); {flips} attention-mask entries differ; kernel-fed leaves, max |diff| "
            f"/ max |CPU grad|: worst {leaf[worst]:.2e} ({worst}), " + ", ".join(
                f"{n.split('.')[-4]}.{n.split('.')[-2]}.{n.split('.')[-1][0]} {e:.1e}" for n, e in leaf.items()))
        return dl, dn, leaf[worst], flips

    original = losses._uniform
    losses._uniform = same_uniform
    try:
        gpu = run("cuda")
        t = time.perf_counter()
        cpu = run("cpu")
        cpu_s = time.perf_counter() - t
        cpu_gpu_masks = run("cpu", gpu[3])
    finally:
        losses._uniform = original
    own = compare("(CPU on its own attention masks)", gpu, cpu)
    same = compare("(CPU on the GPU's attention masks)", gpu, cpu_gpu_masks)
    log(f"step0: limits {STEP0_OWN_RTOL} on its own masks, {STEP0_SAME_RTOL} on the GPU's (loss, norm, leaf); "
        f"each CPU forward and backward {cpu_s:.1f} s")
    for label, got, tols in (("own", own, STEP0_OWN_RTOL), ("GPU", same, STEP0_SAME_RTOL)):
        if not all(x <= tol for x, tol in zip(got, tols)):
            raise AssertionError(f"step 0 on GPU and CPU disagree (CPU on the {label} attention masks): {got[:3]} > {tols}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true",
                    help="also profile one request and one train step: device busy share and the top kernels")
    args = ap.parse_args(argv)

    repo = Path(__file__).resolve().parent
    if not (repo / "rgbdseg_torch" / "csrc").is_dir():
        print("chip_smoke.py: no rgbdseg_torch package beside this script; run it from a checkout",
              file=sys.stderr)
        return 1
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(repo))
    from rgbdseg_torch.ops import kernels as K

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"device: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}; TF32 off")

    log(f"build: {K.build_all():.1f} s")
    for name, text in K.BUILD_LOG.items():
        regs = [ln.split("info    : ")[-1] for ln in text.splitlines() if "registers" in ln]
        log(f"build {name}: {'; '.join(regs)}")

    rng = np.random.RandomState(args.seed)
    dev = torch.device("cuda")
    rows = check_kernels(rng, dev)
    rows.update(check_backward_kernels(rng, dev))
    launches = run_slice(args.seed, rng, args.profile)
    train_launches, step0, batch = run_train(args.seed, rng, args.profile)
    step0_gpu_vs_cpu(step0, batch)
    launches.update({k: train_launches[k] for k in ("deformable_bwd", "masked_attention_bwd")})

    meta = {
        "deform_sample_levels": ("rgbdseg_torch/csrc/deformable.cu", "rgbdseg_tpu/ops/kernels/deformable.py:337", "deformable"),
        "masked_cross_attention": ("rgbdseg_torch/csrc/masked_attention.cu",
                                   "rgbdseg_tpu/ops/kernels/masked_attention.py:148", "masked_attention"),
        "deform_sample_levels_bwd": ("rgbdseg_torch/csrc/deformable_bwd.cu",
                                     "rgbdseg_tpu/ops/kernels/deformable.py:349", "deformable_bwd"),
        "masked_cross_attention_bwd": ("rgbdseg_torch/csrc/masked_attention_bwd.cu",
                                       "rgbdseg_tpu/ops/kernels/masked_attention.py:163", "masked_attention_bwd"),
    }
    kernels = []
    for name, (source, replaces, key) in meta.items():
        rs = rows[name]  # one row per main-path shape; each shape is launched equally often

        def mean(field):
            return sum(r[field] for r in rs) / len(rs)

        _, by = bound_ms(sum(r["bytes"] for r in rs), sum(r["flops"] for r in rs),
                         rs[0].get("flop_rate", F32_FLOP_PER_S))
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[key], "max_abs_err": max(r["err"] for r in rs),
            "ms": mean("ms"), "plain_ms": mean("plain_ms"), "bound_ms": mean("bound_ms"),
            "bound_by": by, "library_ms": mean("library_ms"),
        })
    log(json.dumps({"kernels": kernels}))
    print(f"{smi}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
