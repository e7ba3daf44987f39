"""Drive the PyTorch port (`rgbdseg_torch`) on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--seed N]

Phases, one line of numbers each; any failure raises and the exit code is not 0:
  1. device: the card's name and power limit (nvidia-smi); TF32 off for
     matmuls and convolutions, so the float32 comparisons below mean something;
  2. build: nvcc compiles every kernel under rgbdseg_torch/csrc/, in parallel;
  3. kernels: each CUDA kernel against its plain PyTorch version at the
     480x640 main-path shapes, with its device time, the plain version's and
     one PyTorch library call's (CUDA events around a replayed CUDA graph of
     many calls), and its eager time per call from Python; the point-sampling
     kernel at the criterion's three samplings of a train step's prediction
     layer and on bunched points (against F.grid_sample: bit for bit, else
     the phase fails), each with its per-kernel split and share of its
     bound. K1 is timed at
     the in-model sampling geometry (each query samples 1..4 pixels from its
     reference point along its head's direction, uniform attention weights, as
     the seeded model has them): all levels in one launch, as an encoder layer
     calls it, and each level alone through the per-level entry; uniform random
     coordinates, out of bounds too, are a correctness case only;
  3c. E-DSAM's extract stage (the 3x3 conv from 128 to 256 channels,
     BatchNorm, ReLU and the pool to 4x4 as one hand design) at 480x640: the
     train route at batch 16 (three launches) and the eval route at batch 8
     (one), against the plain version on the card (the cuDNN composition
     the module ran before), running statistics too, two calls bit for bit; device ms
     and each kernel's, the plain version's, the bare library calls' (the
     yardstick), eager ms, and the bound (3xTF32 products on the tensor
     cores, plus the train route's re-read of y);
  4. slice: the full-width 0.4.0 model (Swin-T, 6 deformable encoder layers,
     100 queries, 10 prediction points, 40 labels; seeded random weights)
     answers 3 requests through `Predictor.predict_pixels`, of 10-channel
     stacks that the port's channel builder makes on the CPU from synthetic
     raw 480x640 frames; the kernels' launch counts must show every
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
     a second launch of each that must give the same bits (K1's d value, d
     locations and d weights too); the device time of the
     backward launch, the
     plain backward's and the library yardstick's (the aten grid_sample backward
     for each level; SDPA's forward and backward less its forward), each from a
     replayed CUDA graph, the eager time, and a byte and operation bound;
     then (5b) all four kernels with the bfloat16 operands the bf16 train step
     gives them, at B=2, the backward ones through torch.autograd.grad of their
     wrappers, each against its plain version on the same bfloat16 values,
     timed beside the plain version and the library call in bfloat16; K1 on
     bf16 V equal bit for bit to K1 on V.float(); K1's backward twice with the
     same bits and d value in bfloat16 from the kernels; K3's forward also
     against the float32 plain version of its bf16 values; K3's backward
     against the plain backward in bf16, two launches with the same bits, and
     the effect of its delta (rowsum(dO * O) against the JAX VJP's sum_k dP * P);
     and the point-sampling kernel's backward at the loss's sampling (batch 2,
     16 masks of 120x160, 12544 points) against aten's grid_sampler_2d_backward,
     two launches with the same bits, bit for bit the ordered plain model of
     its sum (`point_sample_bwd_ordered_plain`), timed beside aten's backward;
     on bunched points too (one mask's points all in one lattice cell, one's in
     one band), held to the ordered model alone, timed;
  6. train: 3 optimizer steps (`train_step`) of the full-width 0.4.0 model with
     drop path 0.3, dropout and batch-statistics BatchNorm, on 2 synthetic
     480x640 frames (stacks built as in phase 4) with up to 16 box instances
     each, f32 with TF32 off; per step the
     step time, loss, gradient norm, peak device memory
     and the launches, which must be 6 K1 and 9 K3 forward and backward each
     and 30 point samplings forward and 10 backward (3 and 1 per prediction
     layer); the kernels' gradients must reach value_proj, sampling_offsets,
     attention_weights and the decoder's q/k/v projections;
  6b. step determinism: from phase 6's step-0 weights after one warm-up step,
     two train steps from that saved state (weights, BatchNorm statistics,
     Adam's moments and count, generator state) on phase 6's batch, in float32
     and under the bf16 policy: the loss, every gradient, every parameter and
     buffer after the update and the moments equal bit for bit; the count of
     tensors that differ is printed (0);
  7. step 0 on GPU and CPU: the same weights and batch, the same injected point
     coordinates, dropout and drop path off: the loss, the gradient norm and the
     gradients of the kernel-fed parameters agree, with the CPU on its own
     decoder attention masks and, to a tighter limit, on the GPU's;
  8. channel builder: raw frames of 480x640 and of 720x1280 (a RealSense D435
     colour frame) to the 480x640 0.4.0 stack on the card and on the CPU: the
     grayscale, both resizes and the cv2-resized gray bitwise equal, the
     validity mask bitwise equal, the float channels within 1e-6;
  9. frame requests: 3 `Predictor.predict_example` requests of raw 720x1280
     frames (one packed uint8 upload each, 6 bytes per pixel, the stack built
     on the card), each launching 6 K1 and 9 K3; ms per request, bytes copied
     to the device, and the logits against those of the CPU-built stack
     (numpy's a[None], batch stride 0), which must be equal bit for bit; the
     pixel-level module alone on the two layouts names the first modules
     whose outputs differ without the model's `standard_layout`;
  10. eval: `train.trainer.evaluate` over 8 synthetic 480x640 examples with
     their instance maps, batch 2 (raw frames and bit-packed masks uploaded),
     by the device-stats path and by the host mask path: identical metric
     dicts, 4 x (6 K1 + 9 K3) launches each; images/s, the eval loss and
     eval_map (random weights: printed, not checked); `eval_stats` of the same
     logits on the card and on the CPU: labels and counts equal;
  11. predict surface: a raw 720x1280 RGB frame and its depth written as PNGs
     (`write_png`) and served by `predict_and_overlay_files` (the overlay at
     720x1280, written and read back equal); `train.trainer.predict` over 8
     examples made as the eval phase's and `process_prediction` (prediction and GT
     COCO-RLE JSON, comparison PNGs); the native RLE codec must be in use and
     equal the numpy one on every mask; stage times;
  12. train full: batch 2 of raw 480x640 frames with 15-16 box instances
     padded to 32 slots, uploaded packed (`put_batch`: compacted to the bucket
     of 16, masks bit-packed), the stack built inside the step, gradient
     accumulation over 2 micro-batches: 3 optimizer steps, 6 + 9 launches
     forward and backward per micro-batch; first the compacted, packed
     micro-step against the padded float one from the same weights and points;
  13. bf16 step: from phase 12's weights and batch, one bf16 and one float32
     step: the kernels launched with bfloat16 operands in the bf16 step only,
     the gap in loss and gradient norm within a bound; 3 steady bf16 steps;
     one more under the profiler: the port's kernels' share of device time;
  15. finetune: `finetune_torch.main` on a synthetic set written by the port's
     `data/synthetic.generate` (8 train and 4 valid 480x640 frames, 1-3
     objects each, 3 labels): the full-width 0.4.0 model, 2 epochs at batch 2,
     a checkpoint per epoch with save_total_limit 1, eval per epoch, the HF
     export and every prediction export. Every artifact must be there
     (checkpoint-8 alone, trainer_state.json with 2 loss and 2 eval_map
     entries, train/test/all_results.json, config.json and model.safetensors,
     pred.json, gt.json and the comparison PNGs), each micro-step must launch
     6 K1 and 9 K3 forward and backward; epoch seconds and images/s, and the
     epoch extrapolated to NYUv2's 398 steps. Then resume: a second run
     interrupted right after its epoch-1 checkpoint, a fresh `Trainer` that
     loads it (parameters, BatchNorm statistics, the optimizer's moments and
     count, the CUDA generator's state: all equal to the saved ones bit for
     bit) and trains epoch 2, whose micro-step losses must equal bit for bit
     those of the interrupted run's own epoch 2, trained on from the state it
     saved; the second run's epoch-1 losses must equal the first run's bit for
     bit; whether the first run's own epoch 2 (it evaluated after epoch 1)
     equals them too is printed;
  16. predict entry: `predict_torch.main` on one raw 480x640 PNG pair of that
     set, from `--checkpoint checkpoint-8` and from `--hf_checkpoint` of the
     run's export: the logits equal bit for bit, 6 K1 and 9 K3 launches each,
     the overlay PNG written;
  17. versions: the 13 ablation versions (0.0.1-0.0.7, 0.1.0-0.1.3, 0.2.0,
     0.3.0) at full width, each with seeded weights: 3 `predict_example`
     requests of raw 720x1280 frames built on the card (the two host-only
     layouts, 0.0.4's and 0.2.0's, whose record lists 10 frames, from 480x640
     frames by the host map function), 6 K1 and 9 K3 launches each, request
     ms and a stage split; the card-built stack of raw frames equal to the
     host map function's bit for bit; the logits of that stack on the card
     against a CPU copy's (SLICE_RTOL), on the CPU's own decoder attention
     masks and on the GPU's, with the count of mask entries that differ, at
     480x640 for the four trained versions and at VERSIONS_CMP_HW for the
     others; for 0.1.1 the stack in two layouts gives equal logits. Then a `micro_step` + `apply_step` at batch 2 for 0.0.7,
     0.1.1, 0.2.0 and 0.3.0: finite loss, norm and gradients, 6 + 9 launches
     forward and backward, 0.0.7's intrinsics predictor unchanged bit for
     bit; 0.0.7 and 0.1.1 also step 0 against the CPU (on the GPU's attention
     masks, STEP0_SAME_RTOL);
  18. parallel (`run_parallel`): (a) NCCL at world size 1 in this process,
     one DDP-wrapped step on phase 12's packed batch against the plain step:
     the weights after DDP's construction, the loss, the BatchNorm statistics
     and the generator equal bit for bit, DDP's reduce the identity on every
     gradient, and the gradients, parameters and moments of the DDP step and
     of a second plain step equal the plain step's bit for bit (0 differ);
     then one process at batch 2
     as the reference and two child processes sharing the card over Gloo
     (`--parallel-child`, internal): (b) dp=2 at batch 1 per rank and (c)
     dp=1 x mp=2 at 4 heads, each against the reference on its attention
     masks and assignments (each rank's own flips counted) to phase 7's bounds,
     BatchNorm statistics 1e-5, both ranks' parameters equal bit for bit, (c)
     whether the ranks' replicated gradients agree before the optimizer's
     model-group mean (printed), 6 +
     9 launches forward and backward per rank, the step ms and the time in
     collectives; (d) `Trainer.evaluate` over phase 10's 8 examples in the two
     processes against one, by the device-stats route and by the host mask
     route (RGBDSEG_EVAL_DEVICE_STATS=0: the logits gathered to both ranks):
     metric keys equal, mAP within 1e-6 (the keys equal bit for bit counted),
     loss within 1e-5, the device-stats path logged on its route only, 6 K1 +
     9 K3 launches per batch per rank on both, both routes' mAP keys equal on
     each rank; each route's ms and all-reduced bytes per rank; (e) the QA
     viewers on the card against the CPU, their PNGs read back; then K1, K3
     and both backward kernels at 4 heads against their plain versions, timed
     (phases 3 and 5 at 4 heads);
  20. tools (`run_tools`): (a) `do_depth_image_process` of a seeded 720x1280
     z16 frame (a RealSense D435 depth frame) on the card and the CPU, all 8
     outputs equal bit for bit, ms per frame over 20 frames with each
     operation's share, `save_frame`'s PNGs read back equal; (b) a seeded COCO
     set of 8 480x640 images (convex, concave and border-touching polygons,
     RLE donuts) through `dataset_constructor`, `AnnotationConverter.convert`
     and `convert_to_coco_json`, host ms per image, and the pixels that differ
     when the hole-free polygons are filled again; (c) `finetune_torch.main`
     on the built set (0.4.0 at full width, f32, 1 epoch of 2 steps at batch
     2, the 16-bit masks through `SegmentationDataset`): finite losses, 6 K1 +
     9 K3 launches per micro-step forward and backward; (d) `plot_logs` of its
     trainer_state.json, `mask_check.label_check` of its train meta (the card's
     overlays equal to the CPU's), `predict_torch.py --compare` of its
     prediction and GT JSONs, every PNG read back;
  21. bench (`run_bench`): `bench_torch.bench_infer`, `bench_train`,
     `bench_eval` and `bench_pipeline` (8 synthetic 480x640 examples under
     build/chip_smoke/bench_disk) in this process at 3 timed calls each, at the
     default dtype (bfloat16): bench.py's keys per mode, every number finite
     and positive, MFU in (0, 1], device ms per call within 1.05 x the wall
     ms, and 6 K1 + 9 K3 launches per forward and 6 K1-bwd + 9 K3-bwd per
     train step, all on their bfloat16 routes; then `python3 bench_torch.py`
     in a child process (BENCH_ITERS=3, BENCH_DISK_N=8), whose one stdout line
     must be the merged JSON of BENCH_MODE=all;
  19. a `kernels` JSON line (its launches include phase 18's, the children's
     summed, phase 20's and phase 21's in-process ones); the last line is the
     device JSON.
With --profile, phases 4, 6 and 13 also profile one request, one train step
and one bf16 and one float32 step of phase 13 (torch.profiler): the device's
busy share and the kernels that take the most device time. With
--determinism-probe it runs instead only `determinism_probe`: where a train
step could part from run to run.
It needs one CUDA card and a checkout of the repository around it; without
either it exits with code 1 and prints no result.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
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
TF32_FLOP_PER_S = 495e12  # dense TF32 on the tensor cores
F32_AS_3XTF32_FLOP_PER_S = TF32_FLOP_PER_S / 3
BF16_FLOP_PER_S = 989e12  # dense bfloat16 on the tensor cores
K1_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
K3_TOL, K3_TOL_BF16 = 1e-5, 2e-2
# K3's bf16 forward against the float32 plain version of the same bf16 values,
# relative to that version's largest |output|: the bf16 output's rounding (half
# an ulp, <= 2^-9 relative) and p's; an emulation of the kernel's rounding
# points on the CPU read at most 3.3e-3 over 4 seeds of `mca_inputs` at K =
# 300 / 1200 / 4800, B=2, and the limit is 3x that.
K3_BF16_F32_RTOL = 1e-2
# CPU vs GPU logits of the whole model, relative to the largest |logit|: both
# run float32 with TF32 off, so they differ only by summation order (cuDNN and
# cuBLAS vs the CPU's kernels, the CUDA kernels vs their plain versions), about
# 1e-6 per op over ~40 stacked layers.
SLICE_RTOL = 1e-3
# Backward kernels against their plain versions, relative to the largest |ref|:
# K1 per gradient (its d value is summed in another fixed order than the plain
# sum's, a few ulps of the largest contribution); K3 over d q, d k and d v
# together (with one key, d q and d k are exactly 0 in the plain version). Both
# give the same bits in two launches.
K1_BWD_RTOL = K3_BWD_RTOL = 1e-5
# The backward kernels with bfloat16 operands (tests/test_torch_kernels.py): K1's
# d value comes back in bfloat16, a rounding of each side, so 1e-2 x max |ref|
# (d locations and d weights stay float32: K1_BWD_RTOL); K3 runs bf16 products
# with P and dS rounded to bfloat16 where the JAX VJP rounds them, against the
# plain backward in bfloat16 (torch's autograd rounds at the same points, and
# dP too): 2e-2 x the largest |ref|. K3 also against the float32 plain backward
# of the same bf16 values, which rounds nothing (so it is nearer the kernel than
# the bf16 plain backward is): 1e-2 x the largest |ref|. Both hold on the
# phase's inputs and on those of each seed in K3_BWD_SEEDS; PERF.md gives the
# readings that set them.
K1_BWD_RTOL_BF16_DV, K3_BWD_RTOL_BF16, K3_BWD_RTOL_BF16_F32 = 1e-2, 2e-2, 1e-2
K3_BWD_SEEDS = (1, 2, 3, 4)
TRAIN_B, TRAIN_T = 2, 16  # train batch and real instances per frame
TRAIN_T_MAX = 32  # the train-full phase's padded slots (max_instances), compacted to the bucket of 16
# The compacted and packed micro-step against the padded float one (phase 12):
# the same forward, the criterion over 16 slots instead of 32 with the same
# points; float32 sums in another order, cuDNN's backward and grid_sample's atomics.
TRAIN_FULL_RTOL = 1e-5
# The bf16 step against the float32 one from the same weights and batch
# (phase 13), relative (loss, gradient norm): 5 x the bf16-vs-f32 gap of the
# port's tiny model on the CPU (tests/test_torch_train_full.py setup: 2.70e-2
# and 1.90e-2), written before the first run on the card.
BF16_GAP_BOUND = (0.135, 0.095)
# Step 0 on GPU against CPU, relative (loss, gradient norm, worst kernel-fed
# gradient leaf against its own max): f32 with TF32 off on both, so with the
# same decoder attention masks they differ only by summation orders (cuDNN,
# cuBLAS, the kernels against the CPU). Measured on the H100 at seed 0: 2.4e-7,
# 1.3e-5, 2.4e-4 (the last decoder layer's q projection; the rest 5e-6..1.5e-4).
# On its own masks the CPU may also flip the blocked test of a mask pixel whose
# logit sits at 0 (1 entry at seed 0, the same readings), which moves later
# layers: ten times the slack.
STEP0_SAME_RTOL = (1e-5, 1e-4, 1e-3)
STEP0_OWN_RTOL = (1e-4, 1e-3, 1e-2)
# The channel builder's float channels on the card against the CPU: the same
# float32 operations in the same order (normalise, Sobel sums of integers, a
# square root, one subtraction and one division), each correctly rounded on both.
BUILD_TOL = 1e-6
# Launches per request (the predictor runs no criterion), per eval batch (the
# criterion's three point samplings per prediction layer, 10 layers, no
# backward) and per train step or micro-step (the criterion's 30 forward and 10
# backward point samplings).
# E-DSAM's extract stage (0.4.0 alone): one launch per forward in eval mode,
# three per train-mode forward (products, statistics, apply).
EDSAM_SERVE = {"edsam_extract": 1, "edsam_extract_stats": 0, "edsam_extract_apply": 0}
EDSAM_TRAIN = {"edsam_extract": 1, "edsam_extract_stats": 1, "edsam_extract_apply": 1}
NO_EDSAM = dict.fromkeys(EDSAM_TRAIN, 0)
SERVE_LAUNCHES = {"deformable": 6, "masked_attention": 9, "deformable_bwd": 0, "masked_attention_bwd": 0,
                  "point_sample": 0, "point_sample_bwd": 0, **EDSAM_SERVE}
EVAL_LAUNCHES = dict(SERVE_LAUNCHES, point_sample=30)
TRAIN_LAUNCHES = {"deformable": 6, "masked_attention": 9, "deformable_bwd": 6, "masked_attention_bwd": 9,
                  "point_sample": 30, "point_sample_bwd": 10, **EDSAM_TRAIN}
# E-DSAM's extract stage (phase 3c) against the plain version on the card,
# relative to the plain version's largest |output| and each running
# statistic's: both float32 (3xTF32 products and cuDNN's sums over K = 1152 in
# other orders), a few ulps of the conv's output, scaled up by the
# normalisation; the tests bound both against float64. Batch per route.
EDSAM_RTOL = 1e-4
EDSAM_B = {"train": 16, "eval": 8}
# The point-sampling kernel against the plain version (F.grid_sample and aten's
# backward on the card), relative to the largest |ref|: the forward repeats
# aten's arithmetic (expected bit for bit); the backward sums each cell's <= 4
# x (points per cell) terms in another order than aten's atomics, a few ulps.
POINT_RTOL = POINT_BWD_RTOL = 1e-6
FT_TRAIN, FT_VALID, FT_EPOCHS, FT_B = 8, 4, 2, 2  # the finetune phase's set, epochs and batch
NYU_STEPS = 398  # an NYUv2 epoch: 795 training frames at batch 2
# The versions phase compares the card's logits with the CPU's at 480x640 for
# the four versions it trains and at this size for the other nine, whose CPU
# forwards at full width and 480x640 would hold the phase past its two minutes.
VERSIONS_CMP_HW = (240, 320)
EVAL_N, EVAL_B = 8, 2  # eval examples and batch
LEVELS = ((15, 20), (30, 40), (60, 80))  # deformable levels at 480x640
KEYS = (300, 1200, 4800)  # masked cross-attention keys at 480x640
NH, L, P, HD, NQ = 8, 6300, 4, 32, 100  # heads, queries (all levels' pixels), points
MODEL_NH = NH  # the model's heads; phase 18c times the kernels at one rank's share of them


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


def _split_line(split: dict) -> str:
    return ", ".join(f"{k} {v:.4f} ms" for k, v in split.items()) or "no device events"


def _timed(fn):
    """(fn(), wall ms) with the device synchronised on both sides."""
    import torch

    sync = torch.cuda.synchronize if torch.cuda.is_available() else (lambda: None)
    sync()
    t = time.perf_counter()
    out = fn()
    sync()
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
        loc = initial_locations(LEVELS, MODEL_NH, P, dev)[:, :, :NH].expand(b, -1, -1, -1, -1, -1).contiguous()
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

    q = rng.randn(b, NH, NQ, HD).astype(np.float32) * HD**-0.5
    k = rng.randn(b, NH, nk, HD).astype(np.float32)
    v = rng.randn(b, NH, nk, HD).astype(np.float32)
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


def check_kernels(rng, dev, point_rng=None) -> dict:
    """Phase 3: every kernel against its plain version at the main-path shapes;
    with `point_rng`, the point-sampling kernel too, on inputs from that stream
    (its own, so that these checks leave every later phase's inputs as they
    were)."""
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
    if point_rng is not None:
        rows["point_sample"] = check_point_sample(point_rng, dev)
    torch.cuda.synchronize()
    return rows


def point_sample_inputs(rng, dev):
    """The criterion's three point samplings of one prediction layer at the
    train phase's geometry (batch 2, 16 target slots, mask logits 120x160,
    targets 480x640): (mask logits, 37632 uniform points: the uncertainty
    pass, no gradient), (the logits, the 12544 points it keeps: the loss, whose
    gradient reaches the logits) and (the target masks, the same points: the
    labels). Seeded random logits, targets of random 0/1 pixels."""
    import torch

    from rgbdseg_torch.config import ModelConfig
    from rgbdseg_torch.ops.losses import sample_points_with_uncertainty

    cfg = ModelConfig(num_labels=40, version="0.4.0")
    logits = torch.from_numpy(rng.randn(TRAIN_B, TRAIN_T, 120, 160).astype(np.float32)).to(dev)
    targets = torch.from_numpy((rng.rand(TRAIN_B, TRAIN_T, 480, 640) < 0.3).astype(np.float32)).to(dev)
    gen = torch.Generator(device=dev).manual_seed(int(rng.randint(2**31)))
    uniform = torch.rand(TRAIN_B, TRAIN_T, int(cfg.train_num_points * cfg.oversample_ratio), 2, generator=gen,
                         device=dev)
    chosen = sample_points_with_uncertainty(cfg, logits, gen)
    return [(logits, uniform), (logits, chosen), (targets, chosen)]


def touched_cells(coords, h: int, w: int) -> int:
    """The mask cells the points' bilinear corners read, over all masks: the
    bytes a sampling must read (4 each) on these points."""
    import torch

    from rgbdseg_torch.ops.kernels.point_sample import lattice_keys_plain

    keys = lattice_keys_plain(coords, h, w).reshape(-1, coords.shape[2])
    y0, x0 = keys // (w + 1) - 1, keys % (w + 1) - 1
    mask = torch.arange(keys.shape[0], device=keys.device)[:, None]
    cells = []
    for dy in (0, 1):
        for dx in (0, 1):
            y, x = y0 + dy, x0 + dx
            ok = (keys >= 0) & (y >= 0) & (y < h) & (x >= 0) & (x < w)
            cells.append(((mask * h + y) * w + x)[ok])
    return int(torch.unique(torch.cat(cells)).numel())


def bunched_coords(rng, coords, h: int, w: int):
    """The loss's points with bunched masks, drawn from `rng`: mask 0's points
    all in one lattice cell (one list of P points), mask 1's all in one band
    of 16 rows (more than the backward's shared memory holds), mask 2's half
    in one cell; the rest as they were."""
    import torch

    npts = coords.shape[2]
    c = coords.clone()
    cell = (rng.randint(h // 4, 3 * h // 4), rng.randint(w // 4, 3 * w // 4))
    c[0, 0] = torch.from_numpy(((np.array(cell[::-1]) + rng.uniform(0.5, 1.5, (npts, 2))) / np.array([w, h]))
                               .astype(np.float32))
    c[0, 1, :, 1] = torch.from_numpy(rng.uniform(32 / h, 48 / h, npts).astype(np.float32))
    c[0, 2, : npts // 2] = torch.from_numpy(
        ((np.array([w // 3, h // 3]) + rng.uniform(0.5, 1.5, (npts // 2, 2))) / np.array([w, h])).astype(np.float32))
    return c.to(coords.device)


def longest_list(coords, h: int, w: int) -> int:
    """The most points that share one lattice cell of one mask."""
    from rgbdseg_torch.ops.kernels.point_sample import lattice_keys_plain

    keys = lattice_keys_plain(coords, h, w).reshape(-1, coords.shape[2])
    keys = keys + (keys >= 0) * keys.new_tensor(range(keys.shape[0]))[:, None] * (h + 1) * (w + 1)
    return int(keys[keys >= 0].unique(return_counts=True)[1].max()) if (keys >= 0).any() else 0


def check_point_sample(rng, dev) -> list[dict]:
    """Phase 3, the point-sampling kernel (forward) against `F.grid_sample` at
    the criterion's three samplings and on the loss's points bunched: equal
    bit for bit (else the phase fails); device, eager, plain and library ms,
    the per-kernel split, the bound and its share."""
    import torch
    import torch.nn.functional as F

    from rgbdseg_torch.ops.kernels import point_sample as KP

    rows = []
    inputs = point_sample_inputs(rng, dev)
    masks, coords = inputs[1]
    bunched = (masks, bunched_coords(rng, coords, *masks.shape[2:]))
    for label, (masks, coords) in zip(("uncertainty", "loss", "labels", "bunched"), inputs + [bunched]):
        b, n, h, w = masks.shape
        npts = coords.shape[2]
        got, want = KP.point_sample(masks, coords), KP.point_sample_plain(masks, coords)
        err = _check(f"point_sample {label}", got, want, POINT_RTOL * want.abs().max().item())
        if not torch.equal(got, want):
            raise AssertionError(f"point_sample {label}: not F.grid_sample's bits")
        grid = (2.0 * coords - 1.0).reshape(b * n, 1, npts, 2)
        img = masks.reshape(b * n, 1, h, w)

        def library():
            return F.grid_sample(img, grid, mode="bilinear", padding_mode="zeros", align_corners=False)

        # The mask cells the points read, the coordinates, the output; per point
        # 4 corner weights and 4 multiply-adds.
        nbytes = (touched_cells(coords, h, w) + coords.numel() + got.numel()) * 4
        flops = 8 * b * n * npts
        b_ms, b_by = bound_ms(nbytes, flops)
        row = dict(shape=f"{label}: {b}x{n} masks {h}x{w}, P={npts}", err=err,
                   ms=time_ms(lambda: KP.point_sample(masks, coords)),
                   eager_ms=eager_ms(lambda: KP.point_sample(masks, coords)),
                   plain_ms=time_ms(lambda: KP.point_sample_plain(masks, coords)), library_ms=time_ms(library),
                   bound_ms=b_ms, bound_by=b_by, bytes=nbytes, flops=flops,
                   split=kernel_split(lambda: KP.point_sample(masks, coords)))
        log(f"kernel point_sample {row['shape']}: equal to F.grid_sample bit for bit; ms {row['ms']:.4f} eager_ms "
            f"{row['eager_ms']:.4f} plain_ms {row['plain_ms']:.4f} library_ms {row['library_ms']:.4f} bound_ms "
            f"{b_ms:.4f} ({b_by}), {b_ms / row['ms']:.1%} of it; per kernel: {_split_line(row['split'])}")
        if label != "bunched":  # the kernels line averages the main path's shapes only
            rows.append(row)
    return rows


def check_point_sample_bwd(rng, dev) -> list[dict]:
    """Phase 5, the point-sampling kernel's backward through its autograd
    wrapper at the loss's sampling (the train phase's geometry): against aten's
    `grid_sampler_2d_backward` (the plain backward) within POINT_BWD_RTOL of the
    largest gradient, against the ordered plain model of its sum bit for bit,
    two launches with the same bits (and two of aten's, printed); device,
    eager, plain and library ms, the per-kernel split, the bound and its share.
    Then the same points bunched (`bunched_coords`): against the ordered model
    bit for bit and twice the same bits, timed; aten's difference printed."""
    import torch

    from rgbdseg_torch.ops import kernels as K
    from rgbdseg_torch.ops.kernels import point_sample as KP

    masks, coords = point_sample_inputs(rng, dev)[1]
    b, n, h, w = masks.shape
    npts = coords.shape[2]
    g = torch.from_numpy(rng.randn(b, n, npts).astype(np.float32)).to(dev)

    def autograd():
        leaf = masks.detach().requires_grad_()
        K.reset_launches()
        (d,) = torch.autograd.grad(KP.point_sample(leaf, coords), leaf, g)
        if (K.LAUNCHES["point_sample"], K.LAUNCHES["point_sample_bwd"]) != (1, 1):
            raise AssertionError(f"point_sample_bwd: autograd launched {dict(K.LAUNCHES)}")
        return d

    def plain():
        return KP.point_sample_plain_bwd(masks, coords, g)

    got, ref = autograd(), plain()
    err = _check_grads("point_sample_bwd", [got], [ref], POINT_BWD_RTOL)
    if not torch.equal(got, autograd()):
        raise AssertionError("point_sample_bwd: two launches give different bits")
    if not torch.equal(got, KP.point_sample_bwd_ordered_plain(coords, g, h, w)):
        raise AssertionError("point_sample_bwd: not the bits of the ordered plain model")
    aten_repeats = torch.equal(ref, plain())
    log(f"kernel point_sample_bwd: two launches give the same bits, those of the ordered plain model (longest list "
        f"{longest_list(coords, h, w)} points); aten's grid_sampler_2d_backward twice the same bits: {aten_repeats}")
    grid = (2.0 * coords - 1.0).reshape(b * n, 1, npts, 2)
    img, go = masks.reshape(b * n, 1, h, w), g.reshape(b * n, 1, 1, npts)

    def library():
        return torch.ops.aten.grid_sampler_2d_backward(go, img, grid, 0, 0, False, [True, False])

    def kernel():  # the launch the autograd backward makes, alone, for the CUDA graph
        return KP._launch_bwd(coords, g, h, w)

    # Read the coordinates and grad_out, write the gradient; per point 4 corner
    # weights and 4 multiply-adds.
    nbytes = (coords.numel() + g.numel() + got.numel()) * 4
    flops = 8 * b * n * npts
    b_ms, b_by = bound_ms(nbytes, flops)
    row = dict(shape=f"loss: {b}x{n} masks {h}x{w}, P={npts}", err=err, ms=time_ms(kernel), eager_ms=eager_ms(kernel),
               plain_ms=time_ms(plain), library_ms=time_ms(library), bound_ms=b_ms, bound_by=b_by, bytes=nbytes,
               flops=flops, split=kernel_split(kernel))
    log(f"kernel point_sample_bwd {row['shape']}: ms {row['ms']:.4f} eager_ms {row['eager_ms']:.4f} plain_ms "
        f"{row['plain_ms']:.4f} library_ms {row['library_ms']:.4f} (aten grid_sampler_2d_backward) bound_ms "
        f"{b_ms:.4f} ({b_by}), {b_ms / row['ms']:.1%} of it; per kernel: {_split_line(row['split'])}")

    bunched = bunched_coords(rng, coords, h, w)
    grid_b = (2.0 * bunched - 1.0).reshape(b * n, 1, npts, 2)
    got_b = KP._launch_bwd(bunched, g, h, w)
    model, model_ms = _timed(lambda: KP.point_sample_bwd_ordered_plain(bunched, g, h, w))
    if not (torch.equal(got_b, model) and torch.equal(got_b, KP._launch_bwd(bunched, g, h, w))):
        raise AssertionError("point_sample_bwd bunched: not the ordered model's bits, or two launches differ")
    ref_b = KP.point_sample_plain_bwd(masks, bunched, g)
    ms_b = time_ms(lambda: KP._launch_bwd(bunched, g, h, w), iters=5)
    lib_b = time_ms(lambda: torch.ops.aten.grid_sampler_2d_backward(go, img, grid_b, 0, 0, False, [True, False]),
                    iters=5)
    log(f"kernel point_sample_bwd bunched (longest list {longest_list(bunched, h, w)} points): the ordered model's "
        f"bits, twice the same; ms {ms_b:.4f}, aten's {lib_b:.4f}; against aten {(got_b - ref_b).abs().max().item():.3e}"
        f" of max {ref_b.abs().max().item():.3e} (not held: long lists summed in order); the model took "
        f"{model_ms / 1e3:.1f} s; per kernel: {_split_line(kernel_split(lambda: KP._launch_bwd(bunched, g, h, w), 3))}")
    return [row]


def check_backward_kernels(rng, dev, point_rng=None) -> dict:
    """Phase 5: each backward kernel, reached through its autograd wrapper as the
    train step reaches it, against its plain backward at the train shapes (the
    point-sampling kernel's with `point_rng`, as in `check_kernels`)."""
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
        again = autograd_grads(f"deform_sample_levels_bwd {geometry}", "deformable",
                               lambda v, lc, w: KD.deform_sample_levels(v, LEVELS, lc, w), (value, loc, weights), g)
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"deform_sample_levels_bwd {geometry}: two launches give different bits")
        log(f"kernel deform_sample_levels_bwd {geometry}: two launches give the same bits (d value, d loc, d weights)")

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
    if point_rng is not None:
        rows["point_sample_bwd"] = check_point_sample_bwd(point_rng, dev)
    torch.cuda.synchronize()
    return rows


def k3_bwd_delta_effect(q, k, v, m, ab, out, g, ref) -> str:
    """The bf16 K3 backward's arithmetic written out in float32 on the card
    (P and dS rounded to bf16, S and dP float32), once with the kernel's
    delta = rowsum(dO * O) and once with the JAX VJP's sum_k dP * P; each
    against the bf16 plain backward `ref`, relative to its largest |ref|."""
    import torch

    qf, kf, vf, gf = (t.float() for t in (q, k, v, g))
    blocked = ((m < 0.0) & ~ab[:, :, None])[:, None]
    p = torch.softmax((qf @ kf.transpose(-1, -2)).masked_fill(blocked, -1e9), dim=-1)
    dp = gf @ vf.transpose(-1, -2)
    scale = max(r.abs().max().item() for r in ref)
    errs = {}
    for label, delta in (("rowsum(dO*O)", (gf * out.float()).sum(-1, keepdim=True)),
                         ("sum(dP*P)", (dp * p).sum(-1, keepdim=True))):
        ds = (p * (dp - delta)).bfloat16().float()
        grads = (ds @ kf, ds.transpose(-1, -2) @ qf, p.bfloat16().float().transpose(-1, -2) @ gf)
        errs[label] = max((a - r.float()).abs().max().item() for a, r in zip(grads, ref)) / scale
    return ", ".join(f"{k} {e:.3e} x max" for k, e in errs.items())


def k3_bwd_bf16_errs(got, ref, ref32) -> tuple[float, float, float]:
    """The bf16 K3 backward `got` against the bf16 plain backward `ref` and the
    float32 one `ref32`, and `ref` against `ref32`: each the largest error over
    d q, d k and d v over the largest |ref| (|ref32|) of the three."""
    def rel(a, r):
        r = [t.float() for t in r]
        return max((x.float() - y).abs().max().item() for x, y in zip(a, r)) / max(y.abs().max().item() for y in r)

    return rel(got, ref), rel(got, ref32), rel(ref, ref32)


def check_bf16_kernels(rng, dev) -> list[dict]:
    """Phase 5b: the four kernels with the bfloat16 operands the bf16 train step
    gives them (value for K1; q, k, v and d out for K3), at its shapes (B=2),
    each against its plain version on the same bfloat16 values; the backward
    kernels through `torch.autograd.grad` of their wrappers. K1 on bf16 V also
    equals K1 on V.float() bit for bit; K3's backward gives the same bits in
    two launches and bf16 gradients straight from the kernels, and is also held
    against the float32 plain backward of its bf16 values, on the phase's
    inputs and on those of K3_BWD_SEEDS. Device ms from a
    CUDA graph, eager ms, the plain version's ms and the library call's in
    bfloat16 (grid_sample and its aten backward, SDPA), and the bound with
    bfloat16 bytes (operations: K1 float32 FMAs, K3 at the bfloat16 tensor-core
    rate)."""
    import torch
    import torch.nn.functional as F

    from rgbdseg_torch.ops import kernels as K
    from rgbdseg_torch.ops.kernels import deformable as KD
    from rgbdseg_torch.ops.kernels import masked_attention as KM

    def autograd_grads(key, fn, inputs, g):
        leaves = [t.detach().requires_grad_() for t in inputs]
        K.reset_launches()
        grads = torch.autograd.grad(fn(*leaves), leaves, g)
        if (K.LAUNCHES[key], K.LAUNCHES[f"{key}_bwd"]) != (1, 1):
            raise AssertionError(f"bf16 {key}: autograd launched {dict(K.LAUNCHES)}")
        return grads

    rows = []

    def report(name, shape, err, kernel, plain, library, nbytes, flops, rate):
        b_ms, b_by = bound_ms(nbytes, flops, rate)
        row = dict(name=name, shape=shape, err=err, ms=time_ms(kernel), eager_ms=eager_ms(kernel),
                   plain_ms=time_ms(plain, 10), library_ms=library(), bound_ms=b_ms, bound_by=b_by)
        rows.append(row)
        log(f"kernel bf16 {name} {shape} B={TRAIN_B}: ms {row['ms']:.4f} eager_ms {row['eager_ms']:.4f} plain_ms "
            f"{row['plain_ms']:.4f} library_ms {row['library_ms']:.4f} bound_ms {b_ms:.4f} ({b_by}); "
            f"max_abs_err {err:.3e}")

    value, loc, weights = k1_inputs(rng, dev, "model", TRAIN_B)
    vb = value.bfloat16()
    g = torch.from_numpy(rng.randn(TRAIN_B, L, NH * HD).astype(np.float32)).to(dev)
    starts = [sum(h * w for h, w in LEVELS[:i]) for i in range(len(LEVELS))]
    corners, imgs, grids = 0, [], []
    for lvl, (h, w) in enumerate(LEVELS):
        gx, gy, aw, _ = k1_level(value[:1], loc[:1], weights[:1], lvl)
        corners += TRAIN_B * k1_corners(gx, gy, aw, h, w)
        imgs.append(vb[:, starts[lvl] : starts[lvl] + h * w].permute(0, 2, 3, 1).reshape(TRAIN_B * NH, HD, h, w)
                    .contiguous())
        grids.append((loc[:, :, :, lvl].permute(0, 2, 1, 3, 4).reshape(TRAIN_B * NH, L, P, 2) * 2 - 1)
                     .bfloat16().contiguous())
    got = KD.deform_sample_levels(vb, LEVELS, loc, weights)
    err = _check("bf16 deform_sample_levels", got, KD.deform_sample_levels_plain(vb, LEVELS, loc, weights),
                 K1_TOL["bfloat16"])
    # The widening is exact and the arithmetic the f32 route's: the same bits as V.float().
    vw = vb.float()
    if not torch.equal(got, KD.deform_sample_levels(vw, LEVELS, loc, weights)):
        raise AssertionError("bf16 K1: bf16 V differs from the f32 route on V.float()")
    log(f"kernel bf16 deform_sample_levels equals the f32-V kernel on V.float() bit for bit; f32 V all levels "
        f"B={TRAIN_B} (the bf16 row's shape, for comparison): ms "
        f"{time_ms(lambda: KD.deform_sample_levels(vw, LEVELS, loc, weights)):.4f}")
    report("deform_sample_levels", "all levels", err, lambda: KD.deform_sample_levels(vb, LEVELS, loc, weights),
           lambda: KD.deform_sample_levels_plain(vb, LEVELS, loc, weights),
           lambda: time_ms(lambda: [F.grid_sample(i, gr, align_corners=False) for i, gr in zip(imgs, grids)]),
           vb.numel() * 2 + (loc.numel() + weights.numel() + g.numel()) * 4, corners * HD * 2, F32_FLOP_PER_S)

    got = autograd_grads("deformable", lambda v, lc, w: KD.deform_sample_levels(v, LEVELS, lc, w),
                         (vb, loc, weights), g)
    again = autograd_grads("deformable", lambda v, lc, w: KD.deform_sample_levels(v, LEVELS, lc, w),
                           (vb, loc, weights), g)
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError("bf16 deform_sample_levels_bwd: two launches give different bits")
    ref = KD.deform_sample_levels_plain_bwd(vb, LEVELS, loc, weights, g)
    kernel_dtype = KD._launch_bwd(vb, loc, weights, LEVELS, starts, True, g)[0].dtype
    if got[0].dtype != torch.bfloat16 or kernel_dtype != torch.bfloat16:
        raise AssertionError(f"bf16 K1 backward: d value in {got[0].dtype} ({kernel_dtype} from the kernels)")
    log("kernel bf16 deform_sample_levels_bwd: two launches give the same bits (d value, d loc, d weights); "
        "d value bfloat16 from the kernels")
    err = max(_check_grads("bf16 deform_sample_levels_bwd d value", got[:1], ref[:1], K1_BWD_RTOL_BF16_DV),
              _check_grads("bf16 deform_sample_levels_bwd d loc, d weights", got[1:], ref[1:], K1_BWD_RTOL))
    gos = [torch.randn(TRAIN_B * NH, HD, L, P, device=dev, dtype=torch.bfloat16) for _ in LEVELS]
    report("deform_sample_levels_bwd", "all levels", err,
           lambda: KD._launch_bwd(vb, loc, weights, LEVELS, starts, True, g),
           lambda: KD.deform_sample_levels_plain_bwd(vb, LEVELS, loc, weights, g),
           lambda: time_ms(lambda: [torch.ops.aten.grid_sampler_2d_backward(go, i, gr, 0, 0, False, [True, True])
                                    for go, i, gr in zip(gos, imgs, grids)]),
           2 * vb.numel() * 2 + 2 * (loc.numel() + weights.numel()) * 4 + g.numel() * 4,
           k1_bwd_cells(loc) * HD * 4, F32_FLOP_PER_S)

    for nk in KEYS:
        q, k, v, m, ab = mca_inputs(rng, nk, dev, TRAIN_B)
        qb, kb, vb_ = q.bfloat16(), k.bfloat16(), v.bfloat16()
        gb = torch.from_numpy(rng.randn(*q.shape).astype(np.float32)).to(dev).bfloat16()
        allowed = ~((m < 0) & ~ab[:, :, None])[:, None]
        pairs = q.shape[1] * HD * allowed.sum().item()
        out_b = KM.masked_cross_attention(qb, kb, vb_, m, ab).float()
        err = _check(f"bf16 masked_cross_attention K={nk}", out_b,
                     KM.masked_cross_attention_plain(qb, kb, vb_, m, ab).float(), K3_TOL_BF16)
        # The f32 plain version of the same bf16 values rounds neither the scores nor p.
        ref32 = KM.masked_cross_attention_plain(qb.float(), kb.float(), vb_.float(), m, ab)
        top = ref32.abs().max().item()
        _check(f"bf16 masked_cross_attention K={nk} vs f32 plain (max |ref| {top:.4f}, relative "
               f"{(out_b - ref32).abs().max().item() / top:.3e})", out_b, ref32, K3_BF16_F32_RTOL * top)
        log(f"kernel f32 masked_cross_attention K={nk} B={TRAIN_B} (the bf16 row's shape, for comparison): ms "
            f"{time_ms(lambda: KM.masked_cross_attention(q, k, v, m, ab)):.4f}")
        report("masked_cross_attention", f"K={nk}", err, lambda: KM.masked_cross_attention(qb, kb, vb_, m, ab),
               lambda: KM.masked_cross_attention_plain(qb, kb, vb_, m, ab),
               lambda: time_ms(lambda: F.scaled_dot_product_attention(qb, kb, vb_, attn_mask=allowed, scale=1.0)),
               (2 * qb.numel() + kb.numel() + vb_.numel()) * 2 + m.numel() * 4 + ab.numel(), 4 * pairs,
               BF16_FLOP_PER_S)
        got = autograd_grads("masked_attention", lambda a, b_, c: KM.masked_cross_attention(a, b_, c, m, ab),
                             (qb, kb, vb_), gb)
        again = autograd_grads("masked_attention", lambda a, b_, c: KM.masked_cross_attention(a, b_, c, m, ab),
                               (qb, kb, vb_), gb)
        if not all(torch.equal(a, b_) for a, b_ in zip(got, again)):
            raise AssertionError(f"bf16 masked_cross_attention_bwd K={nk}: two launches give different bits")
        out, lse = KM._launch(qb, kb, vb_, m, ab)
        if any(t.dtype != torch.bfloat16 for t in (*got, *KM._launch_bwd(qb, kb, vb_, m, ab, out, lse, gb))):
            raise AssertionError("bf16 K3 backward: gradients not in bfloat16 from the kernels")
        # Against the plain backward in bf16 (P, dP and dS rounded as the JAX VJP rounds them) and against
        # the float32 plain backward of the same bf16 values.
        ref = KM.masked_cross_attention_plain_bwd(qb, kb, vb_, m, ab, gb)
        err = _check_grads(f"bf16 masked_cross_attention_bwd K={nk} vs bf16 plain", [t.float() for t in got],
                           [t.float() for t in ref], K3_BWD_RTOL_BF16, joint=True)
        ref32 = KM.masked_cross_attention_plain_bwd(qb.float(), kb.float(), vb_.float(), m, ab, gb.float())
        _check_grads(f"bf16 masked_cross_attention_bwd K={nk} vs f32 plain", [t.float() for t in got], ref32,
                     K3_BWD_RTOL_BF16_F32, joint=True)
        readings = [k3_bwd_bf16_errs(got, ref, ref32)]
        for seed in K3_BWD_SEEDS:
            q2, k2, v2, m2, ab2 = mca_inputs(np.random.RandomState(seed), nk, dev, TRAIN_B)
            q2, k2, v2 = q2.bfloat16(), k2.bfloat16(), v2.bfloat16()
            g2 = torch.from_numpy(np.random.RandomState(seed).randn(*q2.shape).astype(np.float32)).to(dev).bfloat16()
            got2 = autograd_grads("masked_attention", lambda a, b_, c: KM.masked_cross_attention(a, b_, c, m2, ab2),
                                  (q2, k2, v2), g2)
            readings.append(k3_bwd_bf16_errs(
                got2, KM.masked_cross_attention_plain_bwd(q2, k2, v2, m2, ab2, g2),
                KM.masked_cross_attention_plain_bwd(q2.float(), k2.float(), v2.float(), m2, ab2, g2.float())))
        worst = [max(r[i] for r in readings) for i in range(3)]
        log(f"kernel bf16 masked_cross_attention_bwd K={nk}: two launches give the same bits; x max |ref|, joint, "
            f"on the phase's inputs and seeds {K3_BWD_SEEDS}: kernel vs bf16 plain "
            f"{' '.join(f'{r[0]:.3e}' for r in readings)} (tol {K3_BWD_RTOL_BF16:g}); kernel vs f32 plain "
            f"{' '.join(f'{r[1]:.3e}' for r in readings)} (tol {K3_BWD_RTOL_BF16_F32:g}); bf16 plain vs f32 plain "
            f"{' '.join(f'{r[2]:.3e}' for r in readings)}; delta choice: "
            f"{k3_bwd_delta_effect(qb, kb, vb_, m, ab, out, gb, ref)}")
        if not (worst[0] <= K3_BWD_RTOL_BF16 and worst[1] <= K3_BWD_RTOL_BF16_F32):
            raise AssertionError(f"bf16 masked_cross_attention_bwd K={nk}: over the seeds {worst[:2]} x max |ref| > "
                                 f"({K3_BWD_RTOL_BF16}, {K3_BWD_RTOL_BF16_F32})")
        qkv = [t.detach().requires_grad_() for t in (qb, kb, vb_)]

        def lib_fwd():
            return F.scaled_dot_product_attention(*qkv, attn_mask=allowed, scale=1.0)

        report("masked_cross_attention_bwd", f"K={nk}", err,
               lambda: KM._launch_bwd(qb, kb, vb_, m, ab, out, lse, gb),
               lambda: KM.masked_cross_attention_plain_bwd(qb, kb, vb_, m, ab, gb),
               lambda: time_ms(lambda: torch.autograd.grad(lib_fwd(), qkv, gb), 20) - time_ms(lib_fwd, 20),
               (2 * (qb.numel() + kb.numel() + vb_.numel()) + 2 * qb.numel()) * 2 + m.numel() * 4
               + lse.numel() * 4 + ab.numel(), 10 * pairs, BF16_FLOP_PER_S)
    torch.cuda.synchronize()
    return rows


def edsam_stage(seed: int, dev, b: int, h: int = 480, w: int = 640):
    """E-DSAM's extract stage at the model's widths: a non-negative input (B,
    128, h, w) like the stage's (a ReLU output times a sigmoid gate), the 3x3
    conv from 128 to 256 channels with torch's initialisation, and a
    BatchNorm with seeded affine and running statistics."""
    import torch

    from rgbdseg_torch.models.layers import BatchNorm2d, Conv2d

    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(b, 128, h, w, device=dev, generator=g).relu_() * torch.rand(b, 128, h, w, device=dev, generator=g)
    torch.manual_seed(seed)
    conv, bn = Conv2d(128, 256, 3, padding=1).to(dev), BatchNorm2d(256, eps=1e-5).to(dev)
    with torch.no_grad():
        bn.weight.copy_(1 + 0.1 * torch.randn(256, device=dev, generator=g))
        bn.bias.copy_(0.1 * torch.randn(256, device=dev, generator=g))
        bn.running_mean.copy_(0.1 * torch.randn(256, device=dev, generator=g))
        bn.running_var.copy_(1 + torch.rand(256, device=dev, generator=g))
    return x, conv, bn


def check_edsam_extract(rng, dev) -> dict:
    """Phase 3c: E-DSAM's extract stage (`ops/kernels/edsam_extract.py`) at
    480x640 on the train route (batch 16, three launches) and the eval route
    (batch 8, one launch): against the plain version on the card (cuDNN's conv
    and BatchNorm, ReLU, the pool), the running
    statistics too; a second call with the same bits; device ms of the kernels
    (and each kernel's, from the profiler), of the plain version and of the
    same composition as bare library calls; eager ms; the bound (3xTF32
    operations on the tensor cores, plus the train route's re-read of y);
    launches per call."""
    import torch
    import torch.nn.functional as F

    from rgbdseg_torch.ops import kernels as K
    from rgbdseg_torch.ops.kernels import edsam_extract as KE

    rows = {"edsam_extract": []}
    for mode, b in EDSAM_B.items():
        training = mode == "train"
        x, conv, bn = edsam_stage(int(rng.randint(2**31 - 1)), dev, b)
        bn.train(training)
        saved = {k: v.clone() for k, v in bn.state_dict().items()}

        def restore():
            bn.load_state_dict(saved)

        def kernel():
            return KE.edsam_extract(x, conv, bn)

        def plain():
            return KE.edsam_extract_plain(x, conv, bn)

        def library():
            y = F.batch_norm(F.conv2d(x, conv.weight, conv.bias, padding=1), bn.running_mean, bn.running_var,
                             bn.weight, bn.bias, training, bn.momentum, bn.eps)
            return F.adaptive_avg_pool2d(F.relu(y), (4, 4))

        with torch.no_grad():
            K.reset_launches()
            got = kernel()
            launches = {n: K.LAUNCHES[n] for n in EDSAM_TRAIN}
            state = {k: v.clone() for k, v in bn.state_dict().items()}
            restore()
            again = kernel()
            restore()
            want = plain()
            scale = want.abs().max()
            err = _check(f"edsam_extract {mode} B={b} (relative)", got / scale, want / scale, EDSAM_RTOL)
            stat_err = max(((state[k] - v).abs().max() / v.abs().max()).item()
                           for k, v in bn.state_dict().items() if k.startswith("running_"))
            if not stat_err <= EDSAM_RTOL or not torch.equal(state["num_batches_tracked"], bn.num_batches_tracked):
                raise AssertionError(f"edsam_extract {mode}: running statistics {stat_err:.3g} > {EDSAM_RTOL}, or "
                                     f"num_batches_tracked {state['num_batches_tracked']} against the plain "
                                     f"version's {bn.num_batches_tracked}")
            if not torch.equal(got, again):
                raise AssertionError(f"edsam_extract {mode}: two calls differ")
            if launches != (EDSAM_TRAIN if training else EDSAM_SERVE):
                raise AssertionError(f"edsam_extract {mode}: launches {launches}")
            restore()
            ms, split = time_ms(kernel, 5), kernel_split(kernel, 3)
            row = dict(shape=f"{mode} B={b} 480x640", err=err, ms=ms, eager_ms=eager_ms(kernel, 5),
                       plain_ms=time_ms(plain, 3), library_ms=time_ms(library, 3))
            restore()
        products = 2 * b * 480 * 640 * 256 * 128 * 9
        nbytes = (x.numel() + b * 256 * 16) * 4 + (2 * b * 256 * 480 * 640 * 4 if training else 0)
        # The tensor cores' 3xTF32 products, then (train) the apply pass's re-read of y.
        bound = 3 * products / TF32_FLOP_PER_S * 1e3 + (b * 256 * 480 * 640 * 4 / HBM_BYTES_PER_S * 1e3 if training else 0)
        row.update(bound_ms=bound, bound_by="operations", bytes=nbytes, flops=products,
                   flop_rate=F32_AS_3XTF32_FLOP_PER_S)
        rows["edsam_extract"].append(row)
        log(f"kernel edsam_extract {row['shape']}: ms {ms:.4f} eager_ms {row['eager_ms']:.4f} plain_ms "
            f"{row['plain_ms']:.4f} library_ms {row['library_ms']:.4f} bound_ms {bound:.4f} (3 x {products / 1e12:.3f} "
            f"TFLOP of TF32 products{' + y re-read' if training else ''}; {nbytes / 1e9:.2f} GB) share "
            f"{bound / ms:.1%}; err {err:.2e}, running statistics {stat_err:.2e}; launches {launches}; "
            f"split {_split_line(split)}")
        del x, got, again, want
        torch.cuda.empty_cache()
    return rows


def synthetic_frame(rng, h: int = 480, w: int = 640, boxes: int = 4):
    """Raw frames as a camera gives them: a uint8 RGB frame (h, w, 3), an 8-bit
    depth plane (h, w) with 1% holes (0) and its instance map (h, w) uint8 (box
    i has id i + 1; later boxes cover earlier ones; 0 is the background). The
    depth is a background plane and `boxes` tilted planar boxes, so the DSAM
    histogram has clear modes."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    depth = 200.0 - 0.05 * yy + rng.uniform(-0.02, 0.02) * xx
    inst = np.zeros((h, w), np.uint8)
    for i in range(boxes):
        y0, x0 = rng.randint(0, h * 3 // 4), rng.randint(0, w * 3 // 4)
        bh, bw = rng.randint(h // 8, h * 2 // 5), rng.randint(w // 8, w * 2 // 5)
        plane = rng.uniform(40, 160) + rng.uniform(-0.1, 0.1) * (yy - y0) + rng.uniform(-0.1, 0.1) * (xx - x0)
        box = (yy >= y0) & (yy < y0 + bh) & (xx >= x0) & (xx < x0 + bw)
        depth = np.where(box, plane, depth)
        inst[box] = i + 1
    depth = np.clip(np.round(depth), 0, 255).astype(np.uint8)
    depth[rng.rand(h, w) < 0.01] = 0  # missing depth
    rgb = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
    return rgb, depth, inst


def depth_rgb(depth: np.ndarray) -> np.ndarray:
    """A gray depth plane as its PNG converts to RGB: (h, w, 3)."""
    return np.repeat(depth[..., None], 3, axis=-1)


def frame_stack(rgb: np.ndarray, depth: np.ndarray, out_hw=(480, 640)) -> np.ndarray:
    """The 0.4.0 channel stack (H, W, 10) float32 of raw frames, built on the
    CPU by the port's channel builder."""
    import torch

    from rgbdseg_torch.config import PreprocessConfig
    from rgbdseg_torch.data.device_preprocess import build_pixels

    pp = PreprocessConfig(height=out_hw[0], width=out_hw[1])
    return build_pixels("map_10channel_case2", torch.from_numpy(rgb)[None],
                        torch.from_numpy(depth_rgb(depth))[None], pp)[0].numpy()


def profile_request(pred, frame, top: int = 15) -> None:
    """One request under torch.profiler (after a warm-up one)."""
    pred.predict_pixels(frame, threshold=0.0)
    profile_call("request", lambda: pred.predict_pixels(frame, threshold=0.0), top)


def profile_call(label: str, fn, top: int = 15) -> tuple[float, float, float]:
    """One call of `fn` under torch.profiler: the device's busy share of the
    wall time and the kernels that take the most device time (profiler
    overhead included in the wall time). Returns (wall ms, device busy ms,
    the port's kernels' device ms)."""
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
    names = (r"deform_sample_bwd_kernel|deform_sample_kernel|mark_kernel|gather_dv_kernel|mca_split_kernel"
             r"|mca_combine_kernel|mca_bwd_dq_kernel|mca_bwd_mask_kernel|mca_bwd_bf16_kernel|mca_bwd_kernel")
    port = {}  # by kernel name, over its instantiations: [device us, count]
    for e in kernels:
        m = re.search(names, e.key)
        if m:
            acc = port.setdefault(m.group(0), [0.0, 0])
            acc[0] += e.self_device_time_total
            acc[1] += e.count
    port_ms = sum(us for us, _ in port.values()) / 1e3
    log(f"profile: port kernels {port_ms:.3f} ms of device time ({100 * port_ms / busy:.1f}%): "
        + ", ".join(f"{k} {us / 1e3:.3f} ms {n}x" for k, (us, n) in port.items()))
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:top]:
        log(f"profile: {e.self_device_time_total / 1e3:8.3f} ms {e.count:5d}x  {e.key[:90]}")
    return wall, busy, port_ms


def run_slice(seed: int, rng, profile: bool = False):
    """Phase 4: the full-width 0.4.0 model serves 3 requests through the kernels.
    Returns the launch counts and the predictor."""
    import torch

    from rgbdseg_torch.config import ModelConfig, PreprocessConfig
    from rgbdseg_torch.inference.postprocess import post_process_instance_segmentation
    from rgbdseg_torch.inference.predictor import Predictor
    from rgbdseg_torch.ops import kernels as K

    cfg = ModelConfig(num_labels=40, version="0.4.0")
    t0 = time.perf_counter()
    pred = Predictor(cfg, device="cuda", seed=seed, preprocess=PreprocessConfig(height=480, width=640))
    frames = [frame_stack(*synthetic_frame(rng)[:2])[None] for _ in range(3)]
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
        if delta != SERVE_LAUNCHES:
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
    return launches, pred


def stack_batch(rng, cfg):
    """Phase 6's batch on the card: TRAIN_B 480x640 float stacks (built as in
    phase 4) with up to TRAIN_T box instances each, TRAIN_T slots."""
    import torch

    from rgbdseg_torch.train.trainer import TrainBatch

    frames, masks = [], []
    for _ in range(TRAIN_B):
        rgb, depth, inst = synthetic_frame(rng, boxes=TRAIN_T)
        frames.append(frame_stack(rgb, depth))
        masks.append(np.stack([inst == i + 1 for i in range(TRAIN_T)]).astype(np.float32))
    masks = np.stack(masks)
    valid = masks.any(axis=(2, 3))  # a box that later boxes cover whole is no instance
    classes = rng.randint(0, cfg.num_labels, (TRAIN_B, TRAIN_T))
    return TrainBatch(*(torch.from_numpy(np.ascontiguousarray(a)).to("cuda") for a in
                        (np.stack(frames), masks, classes, valid)))


def run_train(seed: int, rng, profile: bool = False):
    """Phase 6: 3 optimizer steps of the full-width 0.4.0 model through the kernels
    (and with `profile` a fourth under the profiler). Returns the launch counts
    of the 3 steps, the step-0 weights (on the CPU) and the batch."""
    import torch

    from rgbdseg_torch.config import ModelConfig
    from rgbdseg_torch.ops import kernels as K
    from rgbdseg_torch.train.arguments import TrainingArguments
    from rgbdseg_torch.train.trainer import build_training, train_step

    cfg = ModelConfig(num_labels=40, version="0.4.0")
    args = TrainingArguments(learning_rate=1e-4, weight_decay=0.05, per_device_train_batch_size=TRAIN_B)
    model, opt = build_training(cfg, args, num_examples=3 * TRAIN_B, seed=seed)
    step0 = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    batch = stack_batch(rng, cfg)
    valid = batch.valid.cpu().numpy()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    expected = TRAIN_LAUNCHES
    attn = model.pixel_level_module.pixel_decoder.layer0.self_attn
    cross = model.transformer_module.layer0.cross_attn
    fed = {"value_proj": attn.value_proj, "sampling_offsets": attn.sampling_offsets,
           "attention_weights": attn.attention_weights, "decoder q_proj": cross.q_proj,
           "decoder k_proj": cross.k_proj, "decoder v_proj": cross.v_proj}
    reached = {}  # each kernel-fed weight's |gradient| sum, as the backward leaves it (apply_step clears it)
    hooks = [mod.weight.register_post_accumulate_grad_hook(lambda p, n=name: reached.__setitem__(n, p.grad.abs().sum()))
             for name, mod in fed.items()]
    torch.cuda.reset_peak_memory_stats()
    K.reset_launches()
    for step in range(3):
        before = dict(K.LAUNCHES)
        (loss, per_layer, gnorm), ms = _timed(lambda: train_step(model, opt, batch, gen))
        delta = {k: K.LAUNCHES[k] - before[k] for k in K.LAUNCHES}
        loss, gnorm = loss.item(), gnorm.item()
        log(f"train step {step}: {ms:.2f} ms, loss {loss:.6f}, grad norm "
            f"{gnorm:.6f}, final-layer losses {[round(v[-1].item(), 5) for v in per_layer.values()]}, "
            f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, launches {delta}")
        if not (np.isfinite(loss) and np.isfinite(gnorm)):
            raise AssertionError(f"step {step}: loss {loss}, grad norm {gnorm}")
        if delta != expected:
            raise AssertionError(f"step {step} launched {delta}; expected {expected}")
    for h in hooks:
        h.remove()
    for name in fed:
        if name not in reached or not reached[name].item() > 0:
            raise AssertionError(f"no gradient reached {name} through the kernels")
    log(f"train: {sum(p.numel() for p in model.parameters())} parameters, batch {TRAIN_B}, "
        f"{valid.sum(1).tolist()} instances; gradients reach value_proj, sampling_offsets, attention_weights "
        "and the decoder q/k/v projections")
    launches = dict(K.LAUNCHES)
    if profile:
        profile_call("train step", lambda: train_step(model, opt, batch, gen))
    return launches, step0, batch


def step_state(model, opt) -> dict:
    """Every tensor a train step leaves: parameters, BatchNorm statistics (and
    every other buffer), Adam's moments, by name."""
    state = {f"param {n}": p.detach().clone() for n, p in model.named_parameters()}
    state.update({f"buffer {n}": b.detach().clone() for n, b in model.named_buffers()})
    state.update({f"{k} {n}": m.clone() for n, st in opt.state_dict()["state"].items() for k, m in st.items()})
    return state


def repeat_step(model, opt, batch, saved: dict, record=None) -> dict:
    """One `micro_step` + `apply_step` from `saved` (the model's state dict,
    the optimizer's state and the generator's state): {name: tensor} of the
    loss, every gradient the backward leaves and every tensor of `step_state`
    after the update. `record(name, grad)` is called for each recorded module
    output's gradient as the backward computes it (see `output_grads`)."""
    import torch

    from rgbdseg_torch.train.trainer import apply_step, micro_step

    model.load_state_dict(saved["model"])
    opt.load_state_dict(saved["opt"])
    gen = torch.Generator(device="cuda")
    gen.set_state(saved["rng"])
    opt.zero_grad(set_to_none=True)
    with output_grads(model, record):
        loss, _ = micro_step(model, opt, batch, gen)
    out = {"loss": loss.detach().clone()}
    out.update({f"grad {n}": p.grad.clone() for n, p in model.named_parameters() if p.grad is not None})
    apply_step(opt, 1)
    out.update(step_state(model, opt))
    out["generator"] = gen.get_state()
    return out


@contextlib.contextmanager
def output_grads(model, record):
    """With `record`, a forward hook on every module registers a tensor hook on
    each of its floating outputs that needs a gradient: `record(module name,
    gradient)` in the order the backward computes them."""
    if record is None:
        yield
        return

    import torch

    def hook(name):
        def forward_hook(module, inputs, output):
            for t in (output if isinstance(output, tuple) else (output,)):
                if isinstance(t, torch.Tensor) and t.requires_grad:
                    t.register_hook(lambda g, n=name: record(n, g))
        return forward_hook

    handles = [m.register_forward_hook(hook(n or "model")) for n, m in model.named_modules()]
    try:
        yield
    finally:
        for h in handles:
            h.remove()


def differing(a: dict, b: dict) -> list[str]:
    """The names whose tensors are not equal bit for bit (all of them where the names differ)."""
    import torch

    if a.keys() != b.keys():
        return sorted(a.keys() ^ b.keys())
    return [k for k in a if not torch.equal(a[k], b[k])]


def check_step_determinism(seed: int, step0, batch) -> None:
    """Phase 6b: two full-width 0.4.0 train steps from one saved state (phase
    6's step-0 weights after one warm-up step: the weights, BatchNorm
    statistics, Adam's moments and count, the generator's state) on phase 6's
    batch (2 frames, 16 slots), once in float32 and once under the bf16 policy:
    the loss, every gradient, every parameter and buffer after the update and
    the moments must be equal bit for bit (torch.equal), as the JAX package's
    steps are."""
    import torch

    from rgbdseg_torch.config import ModelConfig
    from rgbdseg_torch.train.arguments import TrainingArguments
    from rgbdseg_torch.train.trainer import build_training, train_step

    cfg = ModelConfig(num_labels=40, version="0.4.0")
    for bf16 in (False, True):
        args = TrainingArguments(learning_rate=1e-4, weight_decay=0.05, per_device_train_batch_size=TRAIN_B, bf16=bf16)
        model, opt = build_training(cfg, args, num_examples=3 * TRAIN_B, seed=seed)
        model.load_state_dict(step0)
        gen = torch.Generator(device="cuda").manual_seed(seed)
        train_step(model, opt, batch, gen)  # Adam's moments and count not at zero
        saved = {"model": {k: v.clone() for k, v in model.state_dict().items()}, "opt": opt.state_dict(),
                 "rng": gen.get_state()}
        runs = [_timed(lambda: repeat_step(model, opt, batch, saved)) for _ in range(2)]
        (a, ms_a), (b, ms_b) = runs
        diff = differing(a, b)
        kinds = {k: sum(n.startswith(k) for n in a) for k in ("grad", "param", "buffer", "mu", "nu")}
        log(f"step determinism {'bf16' if bf16 else 'float32'}: two steps from one saved state, loss "
            f"{a['loss'].item():.7f} / {b['loss'].item():.7f}; {len(diff)} of {len(a)} tensors differ (the loss, "
            + ", ".join(f"{v} {k}" for k, v in kinds.items()) + f", the generator){'' if not diff else f': {diff[:8]}'};"
            f" step ms {ms_a:.1f} / {ms_b:.1f}")
        if diff:
            raise AssertionError(f"two {'bf16' if bf16 else 'float32'} train steps from one state differ in "
                                 f"{len(diff)} tensors: {diff[:20]}")
        del model, opt, runs, a, b
        torch.cuda.empty_cache()


def determinism_probe(seed: int) -> int:
    """`--determinism-probe`: where a full-width 0.4.0 train step (phase 6's
    batch, one warm-up step first) could part from run to run, in float32 and
    under the bf16 policy. (1) One step under
    `torch.use_deterministic_algorithms(True, warn_only=True)`, with
    CUBLAS_WORKSPACE_CONFIG set before CUDA starts: every library operation
    without a deterministic implementation warns and names itself. (2) Two
    ordinary steps from one saved state, every module output's gradient
    recorded as the backward computes it: the first that parts, in the
    backward's order, and every tensor that differs after the step. The hand
    kernels are outside the flag's view; (2) sees them too. Then, in float32,
    (1) and (2) again with each of the two causes the port repaired put back:
    the criterion's point sampling through `F.grid_sample` and aten's backward,
    and cuDNN's default (not deterministic) algorithms."""
    import warnings

    import torch

    from rgbdseg_torch.config import ModelConfig
    from rgbdseg_torch.ops import kernels as K
    from rgbdseg_torch.ops import losses
    from rgbdseg_torch.ops.kernels.point_sample import point_sample_plain
    from rgbdseg_torch.train.arguments import TrainingArguments
    from rgbdseg_torch.train.trainer import build_training, train_step

    def aten_sampling():
        kept = losses.point_sample
        losses.point_sample = point_sample_plain
        return lambda: setattr(losses, "point_sample", kept)

    def cudnn_default():
        torch.backends.cudnn.deterministic = False
        return lambda: setattr(torch.backends.cudnn, "deterministic", True)

    log(f"determinism probe: build {K.build_all():.1f} s; CUBLAS_WORKSPACE_CONFIG="
        f"{os.environ.get('CUBLAS_WORKSPACE_CONFIG')}")
    cfg = ModelConfig(num_labels=40, version="0.4.0")
    batch = stack_batch(np.random.RandomState(seed), cfg)
    for bf16, control in ((False, None), (True, None), (False, aten_sampling), (False, cudnn_default)):
        policy = ("bf16" if bf16 else "float32") + (f", {control.__name__} put back" if control else "")
        args = TrainingArguments(learning_rate=1e-4, weight_decay=0.05, per_device_train_batch_size=TRAIN_B, bf16=bf16)
        model, opt = build_training(cfg, args, num_examples=3 * TRAIN_B, seed=seed)
        restore = control() if control else (lambda: None)
        gen = torch.Generator(device="cuda").manual_seed(seed)
        train_step(model, opt, batch, gen)
        saved = {"model": {k: v.clone() for k, v in model.state_dict().items()}, "opt": opt.state_dict(),
                 "rng": gen.get_state()}
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.use_deterministic_algorithms(True, warn_only=True)
            try:
                repeat_step(model, opt, batch, saved)
            finally:
                torch.use_deterministic_algorithms(False)
        ops = sorted({str(w.message).split(" does not have")[0] for w in caught
                      if "deterministic" in str(w.message)})
        log(f"determinism probe {policy}: under use_deterministic_algorithms(True, warn_only=True), {len(ops)} "
            f"operations without a deterministic implementation: {ops}")
        first = []
        a = repeat_step(model, opt, batch, saved, record=lambda n, g: first.append((n, g.detach().clone())))
        parted, seen = [], []

        def compare(name, g):
            i = len(seen)
            seen.append(name)
            if i >= len(first) or first[i][0] != name or not torch.equal(first[i][1], g):
                parted.append((i, name))

        b = repeat_step(model, opt, batch, saved, record=compare)
        diff = differing(a, b)
        before = [n for n, _ in first[max(0, parted[0][0] - 4):parted[0][0]]] if parted else []
        log(f"determinism probe {policy}: {len(first)} module-output gradients recorded, {len(parted)} part; the "
            f"first in the backward's order: {parted[:6]} (recorded just before it: {before}); {len(diff)} of "
            f"{len(a)} tensors differ after the step: gradients {[d for d in diff if d.startswith('grad')][:24]}")
        restore()
        del model, opt, first, a, b
        torch.cuda.empty_cache()
    return 0


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


def mask_hook(own: list, masks=None):
    """A forward hook for the decoder's mask predictor: it appends each layer's
    attention mask (mask logits, all-blocked rows) to `own` on the CPU, and
    with `masks` replaces it by the given one (moved to the model's device)."""
    def hook(module, inputs, output):
        pred, attn_mask = output
        own.append(tuple(t.cpu() for t in attn_mask))
        if masks is not None:
            return pred, tuple(t.to(pred.device) for t in masks[len(own) - 1])
        return None

    return hook


def step0_gpu_vs_cpu(state, batch, version: str = "0.4.0", own_masks: bool = True) -> None:
    """Phase 7: one forward and backward from the step-0 weights on the GPU and on
    a CPU copy, dropout and drop path off, the same point coordinates injected
    into the criterion on both: loss, gradient norm, and the gradients of the
    kernel-fed parameters each against its own scale. The CPU runs twice: on its
    own decoder attention masks, and on the GPU's (substituted after each mask
    prediction), which shows how much of the difference the masks' sign flips
    at logit 0 make; with `own_masks` False (the versions phase) only on the
    GPU's, to the tighter limits."""
    import torch

    from rgbdseg_torch.config import ModelConfig
    from rgbdseg_torch.models.mask2former import Mask2FormerRGBD
    from rgbdseg_torch.models.stochastic import Dropout
    from rgbdseg_torch.models.swin import SwinBlock
    from rgbdseg_torch.ops import losses
    from rgbdseg_torch.train.optim import global_norm

    cfg = ModelConfig(num_labels=40, version=version)
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
        model.transformer_module.mask_predictor.register_forward_hook(mask_hook(own, masks))
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
        cpu_gpu_masks = run("cpu", gpu[3])
        cpu_s = time.perf_counter() - t
        cpu = run("cpu") if own_masks else None
    finally:
        losses._uniform = original
    checks = [("GPU", compare(f"{version} (CPU on the GPU's attention masks)", gpu, cpu_gpu_masks), STEP0_SAME_RTOL)]
    if own_masks:
        checks.insert(0, ("own", compare(f"{version} (CPU on its own attention masks)", gpu, cpu), STEP0_OWN_RTOL))
    log(f"step0 {version}: limits {STEP0_OWN_RTOL} on its own masks, {STEP0_SAME_RTOL} on the GPU's (loss, norm, "
        f"leaf); each CPU forward and backward {cpu_s:.1f} s")
    for label, got, tols in checks:
        if not all(x <= tol for x, tol in zip(got, tols)):
            raise AssertionError(f"step 0 on GPU and CPU disagree (CPU on the {label} attention masks): {got[:3]} > {tols}")


def check_builder(rng, dev) -> None:
    """Phase 8: the channel builder on the card against the CPU, from raw frames
    at the target size and at a RealSense D435 colour size: the uint8 stages
    bitwise, the validity mask bitwise, the float channels within BUILD_TOL."""
    import torch

    from rgbdseg_torch.config import PreprocessConfig
    from rgbdseg_torch.data.device_preprocess import build_pixels, pil_grayscale_u8
    from rgbdseg_torch.ops.resize_exact import cv2_resize_linear_u8, pil_resize_u8

    pp = PreprocessConfig(height=480, width=640)
    stages = {
        "gray": lambda r, d: pil_grayscale_u8(d),
        "rgb PIL-resized": lambda r, d: pil_resize_u8(r, (480, 640), has_channels=True),
        "depth PIL-resized": lambda r, d: pil_resize_u8(d, (480, 640), has_channels=True),
        "gray cv2-resized": lambda r, d: cv2_resize_linear_u8(pil_grayscale_u8(d), (480, 640), has_channels=False),
    }
    for h, w in ((480, 640), (720, 1280)):
        rgb, depth, _ = synthetic_frame(rng, h, w)
        cpu = [torch.from_numpy(a)[None] for a in (rgb, depth_rgb(depth))]
        gpu = [t.to(dev) for t in cpu]
        for name, fn in stages.items():
            if not torch.equal(fn(*gpu).cpu(), fn(*cpu)):
                raise AssertionError(f"builder {h}x{w}: {name} differs between the card and the CPU")
        times = [_timed(lambda: build_pixels("map_10channel_case2", *gpu, pp))[1] for _ in range(3)]
        got = build_pixels("map_10channel_case2", *gpu, pp).cpu()
        ref = build_pixels("map_10channel_case2", *cpu, pp)
        if not torch.equal(got[..., 9], ref[..., 9]):
            raise AssertionError(f"builder {h}x{w}: validity masks differ between the card and the CPU")
        err = (got[..., :9] - ref[..., :9]).abs().max().item()
        log(f"builder {h}x{w} -> 480x640: uint8 stages ({', '.join(stages)}) and validity mask bitwise equal on "
            f"the card and the CPU; float channels max_abs_diff {err:.3e} (tol {BUILD_TOL:g}), bitwise "
            f"{torch.equal(got, ref)}; build on the card {sorted(times)[1]:.2f} ms (median of 3)")
        if not err <= BUILD_TOL:
            raise AssertionError(f"builder {h}x{w}: float channels differ by {err}")


def _launch_check(label: str, expected: dict) -> None:
    from rgbdseg_torch.ops import kernels as K

    if dict(K.LAUNCHES) != expected:
        raise AssertionError(f"{label} launched {dict(K.LAUNCHES)}; expected {expected}")


def run_frame_requests(rng, pred) -> None:
    """Phase 9: 3 `predict_example` requests of raw 720x1280 frames, each one
    packed uint8 upload built into the 480x640 stack on the card; each must launch
    6 K1 and 9 K3. Then the logits of the raw path against those of the stack the
    CPU builds of the same frames."""
    import torch

    from rgbdseg_torch.ops import kernels as K

    frames = [synthetic_frame(rng, 720, 1280)[:2] for _ in range(3)]
    per_request = []
    for i, (rgb, depth) in enumerate(frames):
        K.reset_launches()
        res, ms = _timed(lambda: pred.predict_example({"image": [rgb, depth]}, threshold=0.0))
        _launch_check(f"frame request {i}", SERVE_LAUNCHES)
        per_request.append(ms)
        log(f"frame request {i}: {ms:.2f} ms, {pred.last_upload_bytes} bytes host to device "
            f"({pred.last_upload_bytes / (720 * 1280):g} B/px of 720x1280), {len(res['segments_info'])} segments, "
            f"masks {res['segmentation'].shape}, launches {dict(K.LAUNCHES)}")
    rgb, depth = frames[0]
    raw = [t.cpu() for t in pred._forward_raw([rgb, depth_rgb(depth)])]
    stack = torch.from_numpy(frame_stack(rgb, depth)[None]).to(pred.device)
    ref = [t.cpu() for t in pred._forward(stack)]
    # the same stack forwarded again: how far the forward itself varies from run to run
    again = [t.cpu() for t in pred._forward(stack)]
    for name, g, c, a in zip(("class", "mask"), raw, ref, again):
        diff = (g - c).abs().max().item()
        log(f"frame request {name} logits, stack built on the card vs the CPU-built stack (numpy's a[None], batch "
            f"stride 0): max_abs_diff {diff:.3e} (must be 0); the CPU-built stack forwarded twice: max_abs_diff "
            f"{(a - c).abs().max().item():.3e}")
        if not (torch.isfinite(g).all() and diff == 0):
            raise AssertionError(f"frame request {name} logits differ by {diff}")
    # The layout trace: the pixel-level module alone (without the model's
    # standard_layout) on the two layouts, the first modules whose outputs differ.
    lines = trace_layouts(pred.model.pixel_level_module, stack, stack.clone(memory_format=torch.contiguous_format))
    for line in lines or ["no module's output differs"]:
        log(f"frame request layout trace (pixel-level module, batch stride 0 vs full): {line}")
    log(f"frame requests: per-request ms {[round(x, 3) for x in per_request]}")

    # Where a frame request's time goes: each stage synchronised, the median of 3.
    from rgbdseg_torch.data.device_preprocess import build_pixels
    from rgbdseg_torch.inference.postprocess import post_process_instance_segmentation

    flat_np, n = np.concatenate([rgb.reshape(-1), depth_rgb(depth).reshape(-1)]), rgb.size
    stages = {"upload": [], "build": [], "forward": [], "post_process": []}
    for _ in range(3):
        flat, t_up = _timed(lambda: torch.from_numpy(flat_np).to(pred.device))
        pix, t_build = _timed(lambda: build_pixels("map_10channel_case2", flat[:n].reshape(1, *rgb.shape),
                                                   flat[n:].reshape(1, *rgb.shape), pred.preprocess))
        (cls, masks), t_fwd = _timed(lambda: pred._forward(pix))
        _, t_post = _timed(lambda: post_process_instance_segmentation(cls, masks, threshold=0.0,
                                                                      target_sizes=[(480, 640)]))
        for k, t in zip(stages, (t_up, t_build, t_fwd, t_post)):
            stages[k].append(t)
    log("frame request stages ms (median of 3): " + ", ".join(f"{k} {sorted(v)[1]:.2f}" for k, v in stages.items()))
    # Whether the logits' difference above comes from the stacks or from the forward.
    logit_diffs = [[(a.cpu() - b).abs().max().item() for a, b in zip((cls, masks), other)] for other in (raw, ref)]
    log(f"frame request 0: stack built on the card vs on the CPU bitwise {torch.equal(pix, stack)}, max_abs_diff "
        f"{(pix - stack).abs().max().item():.3e}; its (class, mask) logits vs the raw path's {logit_diffs[0]}, "
        f"vs the CPU-built stack's {logit_diffs[1]}")


def trace_layouts(model, x_a, x_b) -> list[str]:
    """Forward x_a and x_b (the same values in two layouts) through `model` in
    eval mode with a hook on every module; returns a line for each of the first
    modules (in the order they finish) whose output differs between the two,
    with their inputs' strides and whether the inputs were equal."""
    import torch

    records = {0: [], 1: []}
    run = [0]

    def first_tensor(t):
        while isinstance(t, (tuple, list)) and t:
            t = t[0]
        return t if isinstance(t, torch.Tensor) else None

    def hook(name):
        def fn(module, inputs, output):
            i, o = first_tensor(inputs), first_tensor(output)
            if o is not None:
                records[run[0]].append((name, type(module).__name__, None if i is None else i.detach().clone(),
                                        None if i is None else tuple(i.stride()), o.detach().clone()))
        return fn

    handles = [m.register_forward_hook(hook(n)) for n, m in model.named_modules() if n]
    try:
        with torch.no_grad():
            for k, x in enumerate((x_a, x_b)):
                run[0] = k
                model(x)
    finally:
        for h in handles:
            h.remove()
    lines = []
    for (name, kind, ia, sa, oa), (_, _, ib, sb, ob) in zip(records[0], records[1]):
        if torch.equal(oa, ob):
            continue
        same_in = ia is not None and ib is not None and torch.equal(ia, ib)
        lines.append(f"{name} ({kind}): output max_abs_diff {(oa - ob).abs().max().item():.3e}; inputs equal "
                     f"{same_in}, input strides {sa} vs {sb}")
        if len(lines) == 3:
            break
    return lines


def eval_batches(rng, n: int = EVAL_N, b: int = EVAL_B):
    """n synthetic 480x640 examples in batches of b: raw frames packed uint8
    (b, 480, 640, 6); instances from each annotation (instance ids in channel 1,
    semantic ids in channel 2, as the annotation PNGs hold them) through the
    registry's mask path, padded to the most instances, and bit-packed."""
    from rgbdseg_torch.config import PreprocessConfig
    from rgbdseg_torch.data import registry as R
    from rgbdseg_torch.data.pipeline import Batch

    pp = PreprocessConfig(height=480, width=640)
    examples = []
    for _ in range(n):
        rgb, depth, inst = synthetic_frame(rng, boxes=8)
        semantic = rng.randint(1, 40, 256).astype(np.uint8)
        semantic[0] = 0
        ann = np.stack([np.zeros_like(inst), inst, semantic[inst]], axis=-1)
        masks, labels = R._labels(*R._mask_and_mapping(ann), pp)
        examples.append((np.concatenate([rgb, depth_rgb(depth)], axis=-1), masks, labels))
    t = max(len(e[2]) for e in examples)
    batches = []
    for s in range(0, n, b):
        chunk = examples[s : s + b]
        masks = np.zeros((len(chunk), t, 480, 640), np.float32)
        classes = np.zeros((len(chunk), t), np.int64)
        valid = np.zeros((len(chunk), t), bool)
        for i, (_, m, c) in enumerate(chunk):
            masks[i, : len(c)], classes[i, : len(c)], valid[i, : len(c)] = m, c, True
        batches.append(Batch(np.stack([e[0] for e in chunk]), masks, classes, valid,
                             mask_labels_packed=np.packbits(masks.astype(bool).reshape(len(chunk), t, -1), axis=-1)))
    return batches


def run_eval(rng, pred) -> list:
    """Phase 10: `train.trainer.evaluate` on the card over EVAL_N examples in
    batches of EVAL_B (raw frames built on the card, packed GT), by the
    device-stats path and by the host mask path: the metric dicts must be
    identical. Then `eval_stats` of one batch's logits on the card and on the
    CPU: labels and counts equal, scores within 1e-6 relative. Returns the
    batches (phase 18 evaluates them again in two processes)."""
    import os

    import torch

    from rgbdseg_torch.config import PreprocessConfig
    from rgbdseg_torch.data.device_preprocess import build_from_packed
    from rgbdseg_torch.inference.postprocess import eval_stats
    from rgbdseg_torch.ops import kernels as K
    from rgbdseg_torch.train.trainer import evaluate

    pp = PreprocessConfig(height=480, width=640)
    batches = eval_batches(rng)
    id2label = {i: f"class{i}" for i in range(pred.cfg.num_labels)}
    expected = {k: v * len(batches) for k, v in EVAL_LAUNCHES.items()}
    results = {}
    previous = os.environ.get("RGBDSEG_EVAL_DEVICE_STATS")
    try:
        for path, switch in (("device stats", "1"), ("host masks", "0")):
            os.environ["RGBDSEG_EVAL_DEVICE_STATS"] = switch
            K.reset_launches()
            metrics, ms = _timed(lambda: evaluate(pred.model, batches, id2label, pp))
            _launch_check(f"eval ({path})", expected)
            results[path] = metrics
            log(f"eval ({path}): {EVAL_N} images in batches of {EVAL_B} in {ms:.1f} ms, "
                f"{metrics['eval_samples_per_second']} images/s, eval_loss {metrics['eval_loss']:.6f}, "
                f"eval_map {metrics['eval_map']:.6f}, eval_map_50 {metrics['eval_map_50']:.6f} (random weights: "
                f"printed, not checked), launches {dict(K.LAUNCHES)}")
    finally:
        if previous is None:
            os.environ.pop("RGBDSEG_EVAL_DEVICE_STATS", None)
        else:
            os.environ["RGBDSEG_EVAL_DEVICE_STATS"] = previous
    timing = ("eval_runtime", "eval_samples_per_second")
    dev_m, host_m = ({k: v for k, v in m.items() if k not in timing} for m in results.values())
    if dev_m != host_m:
        diff = {k: (dev_m.get(k), host_m.get(k)) for k in set(dev_m) | set(host_m) if dev_m.get(k) != host_m.get(k)}
        raise AssertionError(f"eval metrics differ between the device-stats and the host paths: {diff}")
    log(f"eval: the device-stats and host-mask paths give identical metrics ({len(dev_m)} keys)")

    batch = batches[0]
    with torch.no_grad():
        pix = build_from_packed("map_10channel_case2", torch.from_numpy(batch.pixel_values).to(pred.device), pp)
        out = pred.model(pix)
    args = (out.class_queries_logits, out.masks_queries_logits, torch.from_numpy(batch.mask_labels_packed),
            torch.from_numpy(batch.valid))
    gpu = [t.cpu() for t in eval_stats(*(a.to(pred.device) for a in args), (480, 640), (480, 640))]
    cpu = eval_stats(*(a.cpu() for a in args), (480, 640), (480, 640))
    score_err = ((gpu[0] - cpu[0]).abs() / cpu[0].abs().clamp(min=1e-30)).max().item()
    equal = [torch.equal(g, c) for g, c in zip(gpu[1:], cpu[1:])]
    log(f"eval_stats card vs CPU on the same logits: labels, darea, garea, inter equal {equal}; scores max rel "
        f"diff {score_err:.2e} (bitwise {torch.equal(gpu[0], cpu[0])}); {int(gpu[4].sum().item())} intersecting pixels")
    if not all(equal) or not score_err <= 1e-6:
        raise AssertionError("eval_stats differ between the card and the CPU")

    # Where an eval batch's time goes: each stage synchronised, the median of 3.
    from rgbdseg_torch.data.device_preprocess import unpack_masks
    from rgbdseg_torch.ops.losses import mask2former_loss
    from rgbdseg_torch.train.evaluator import Evaluator

    ev, gen = Evaluator(id2label), torch.Generator(device=pred.device).manual_seed(0)
    stages = {"upload": [], "build": [], "forward": [], "loss": [], "stats": [], "metric": []}
    with torch.no_grad():
        for _ in range(3):
            (px, pk, cl, vd), t_up = _timed(lambda: [torch.from_numpy(np.ascontiguousarray(a)).to(pred.device) for a in (
                batch.pixel_values, batch.mask_labels_packed, batch.class_labels, batch.valid)])
            pix, t_build = _timed(lambda: build_from_packed("map_10channel_case2", px, pp))
            out, t_fwd = _timed(lambda: pred.model(pix))
            _, t_loss = _timed(lambda: mask2former_loss(pred.cfg, out, unpack_masks(pk, (480, 640)), cl, vd, gen))
            stats, t_stats = _timed(lambda: Evaluator._materialize_stats([t.cpu() for t in eval_stats(
                out.class_queries_logits, out.masks_queries_logits, pk, vd, (480, 640), (480, 640))]))
            _, t_metric = _timed(lambda: ev.update_from_stats(stats, batch.class_labels, batch.valid))
            for k, t in zip(stages, (t_up, t_build, t_fwd, t_loss, t_stats, t_metric)):
                stages[k].append(t)
    log(f"eval stages ms, one batch of {EVAL_B} (median of 3): "
        + ", ".join(f"{k} {sorted(v)[1]:.2f}" for k, v in stages.items()))
    return batches


class EvalSet:
    """Eval examples (`eval_batches`) as the duck-typed dataset `process_prediction`
    reads: (the card-built float stack, masks, classes, valid) per example."""

    def __init__(self, batches, stacks):
        self.items = [(stack, b.mask_labels[i], b.class_labels[i], b.valid[i])
                      for b, batch_stacks in zip(batches, stacks) for i, stack in enumerate(batch_stacks)]

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]


def run_predict_surface(rng, pred, out_dir: Path) -> None:
    """Phase 11: the predict surface at full width. A raw 720x1280 RGB frame and
    its depth plane written as PNGs with `write_png`, served from the files by
    `predict_and_overlay_files` (the overlay at the RGB's size, written and read
    back); `train.trainer.predict` over 8 examples made as the eval phase's, then
    `process_prediction` writes the prediction and GT COCO-RLE JSON and the
    comparison PNGs; the native RLE codec must be in use and give the numpy
    codec's string for every mask. Stage times: forward, post-processing, RLE
    and JSON, PNG writing."""
    import torch

    from rgbdseg_torch.config import PreprocessConfig
    from rgbdseg_torch.data.device_preprocess import build_from_packed
    from rgbdseg_torch.data.image_io import read_png, write_png
    from rgbdseg_torch.inference import export, rle, visualize
    from rgbdseg_torch.ops import kernels as K
    from rgbdseg_torch.train.trainer import predict

    out_dir.mkdir(parents=True, exist_ok=True)
    rgb, depth, _ = synthetic_frame(rng, 720, 1280)
    paths = [str(out_dir / "frame_rgb.png"), str(out_dir / "frame_depth.png")]
    _, t_write = _timed(lambda: [write_png(p, a) for p, a in zip(paths, (rgb, depth))])
    if not (np.array_equal(read_png(paths[0]), rgb) and np.array_equal(read_png(paths[1]), depth)):
        raise AssertionError("write_png: the frame PNGs do not read back equal")
    overlay = str(out_dir / "overlay.png")
    K.reset_launches()
    (res, vis), ms = _timed(lambda: pred.predict_and_overlay_files(paths, threshold=0.0, save=overlay))
    _launch_check("predict_and_overlay_files", SERVE_LAUNCHES)
    if vis.shape != (720, 1280, 3) or not np.array_equal(read_png(overlay), vis):
        raise AssertionError(f"overlay {vis.shape} is not the RGB's size or does not read back equal")
    log(f"predict surface: frame PNGs written in {t_write:.1f} ms; predict_and_overlay_files {ms:.2f} ms, "
        f"{len(res['segments_info'])} segments at {res['segmentation'].shape[1:]}, overlay {vis.shape} written "
        f"and read back equal, launches {dict(K.LAUNCHES)}")

    pp = PreprocessConfig(height=480, width=640)
    batches = eval_batches(rng)
    id2label = {i: f"class{i}" for i in range(pred.cfg.num_labels)}
    K.reset_launches()
    (outputs, metrics), t_fwd = _timed(lambda: predict(pred.model, batches, id2label, pp, num_examples=EVAL_N))
    _launch_check("trainer.predict", {k: 2 * v * len(batches) for k, v in EVAL_LAUNCHES.items()})
    if [o[0].shape for o in outputs] != [(EVAL_B, pred.cfg.num_queries, pred.cfg.num_labels + 1)] * len(batches) \
            or not all(
            np.isfinite(o[1]).all() for o in outputs):
        raise AssertionError("trainer.predict: logits of the wrong shape or not finite")
    with torch.no_grad():
        stacks = [build_from_packed("map_10channel_case2", torch.from_numpy(b.pixel_values).to(pred.device), pp)
                  .cpu().numpy() for b in batches]
    data = EvalSet(batches, stacks)
    files = {k: str(out_dir / k) for k in ("pred.json", "gt.json", "comparison")}
    # Where process_prediction's time goes: its stages timed inside the one call.
    stages = {"post_process": 0.0, "rle_and_json": 0.0, "png_writing": 0.0}
    patched = [(export, "post_process_instance_segmentation", "post_process"),
               (export, "predictions_to_json", "rle_and_json"), (export, "gt_to_json", "rle_and_json"),
               (visualize, "save_comparison_images", "png_writing")]
    originals = [getattr(m, n) for m, n, _ in patched]

    def timing(fn, stage):
        def call(*a, **k):
            out, t = _timed(lambda: fn(*a, **k))
            stages[stage] += t
            return out
        return call

    for (m, n, stage), fn in zip(patched, originals):
        setattr(m, n, timing(fn, stage))
    try:
        results, t_all = _timed(lambda: export.process_prediction(
            outputs, data, id2label, files["pred.json"], files["gt.json"], files["comparison"], threshold=0.0))
    finally:
        for (m, n, _), fn in zip(patched, originals):
            setattr(m, n, fn)
    written = sorted(os.listdir(files["comparison"]))
    if len(results) != EVAL_N or len(written) != EVAL_N:
        raise AssertionError(f"process_prediction: {len(results)} results, {len(written)} comparison PNGs")
    preds, gts = (json.load(open(files[k])) for k in ("pred.json", "gt.json"))
    n_masks = sum(len(r["segments_info"]) for r in results)
    if len(preds) != n_masks or len(gts) != sum(int(b.valid.sum()) for b in batches):
        raise AssertionError("process_prediction: JSON record counts differ from the results and the GT")

    codec = rle.codec()
    if not codec.startswith("native"):
        raise AssertionError(f"the native RLE codec did not load: {codec}")
    masks = [m for r in results for m in r["segmentation"]] + [m for _, ms_, _, v in data.items for m in ms_[v]]
    for m in masks:
        counts = rle.mask_to_counts(m)
        if rle.encode_counts_string(counts) != rle._encode_counts_np(counts):
            raise AssertionError("native and numpy RLE strings differ")

    log(f"predict surface: trainer.predict over {EVAL_N} examples in batches of {EVAL_B} (the forward twice: "
        f"logits, then the test_ metrics) {t_fwd:.1f} ms, test_loss {metrics['test_loss']:.6f}; "
        f"process_prediction {t_all:.1f} ms: {n_masks} predicted and {len(gts)} GT masks as COCO-RLE, "
        f"{len(written)} comparison PNGs; RLE codec {codec}, its strings equal the numpy codec's for all "
        f"{len(masks)} masks")
    log(f"predict surface stages ms: forward {t_fwd:.2f} (trainer.predict, with its metrics pass); inside "
        f"process_prediction: " + ", ".join(f"{k} {v:.2f}" for k, v in stages.items())
        + f", the rest (JSON dumps, directories) {t_all - sum(stages.values()):.2f}")


def train_batch(rng, cfg, t_max: int = TRAIN_T_MAX, boxes: int = TRAIN_T):
    """A batch of TRAIN_B raw 480x640 frames packed uint8 (B, 480, 640, 6), with
    up to `boxes` box instances each from the instance map, padded to `t_max`
    slots, and the masks' bit-packed twin; and the float stack the card builds
    of the same frames."""
    from rgbdseg_torch.data.pipeline import Batch

    frames, masks = [], np.zeros((TRAIN_B, t_max, 480, 640), np.float32)
    for i in range(TRAIN_B):
        rgb, depth, inst = synthetic_frame(rng, boxes=boxes)
        frames.append(np.concatenate([rgb, depth_rgb(depth)], axis=-1))
        masks[i, :boxes] = np.stack([inst == j + 1 for j in range(boxes)])
    valid = masks.any(axis=(2, 3))  # a box that later boxes cover whole is no instance
    classes = rng.randint(0, cfg.num_labels, (TRAIN_B, t_max))
    packed = np.packbits(masks.astype(bool).reshape(TRAIN_B, t_max, -1), axis=-1)
    return Batch(np.stack(frames), masks, classes, valid, mask_labels_packed=packed)


def slot_stable_uniform(shape_limits):
    """Point coordinates that depend only on (slot, point), as the CPU tests
    inject them: the first n slots of a (b, n, s, 2) draw are the same for every
    n, so a criterion over 16 compacted slots samples the points the one over
    32 padded slots samples for the same real instances."""
    import torch

    b, n, s = shape_limits
    master = torch.from_numpy(np.random.RandomState(7).rand(b, n, s, 2).astype(np.float32))

    def uniform(generator, shape):
        if len(shape) == 3:  # the matcher's (B, P, 2)
            return master[: shape[0], 0, : shape[1]]
        return master[: shape[0], : shape[1], : shape[2]]

    return uniform


def run_train_full(seed: int, rng, pp_hw=(480, 640)):
    """Phase 12: the 0.4.0 train step as a user runs it: raw uint8 frames and
    bit-packed masks uploaded (`put_batch`: targets compacted from 32 slots to
    the bucket of 16), the stack built inside the step, and
    gradient_accumulation_steps=2: 3 optimizer steps of 2 micro-batches each.
    First, from the step-0 weights and a re-seeded generator, the compacted and
    packed micro-step against the padded one with float masks and the card-built
    float stack: loss and gradient norm within TRAIN_FULL_RTOL. Returns the
    step-0 state, the two micro-batches and the steady step times."""
    import torch

    from rgbdseg_torch.config import ModelConfig, PreprocessConfig
    from rgbdseg_torch.data.device_preprocess import build_from_packed
    from rgbdseg_torch.data.pipeline import Batch
    from rgbdseg_torch.ops import kernels as K
    from rgbdseg_torch.ops import losses
    from rgbdseg_torch.train.arguments import TrainingArguments
    from rgbdseg_torch.train.optim import global_norm
    from rgbdseg_torch.train.trainer import apply_step, build_training, micro_step, put_batch

    cfg = ModelConfig(num_labels=40, version="0.4.0")
    pp = PreprocessConfig(height=pp_hw[0], width=pp_hw[1])
    args = TrainingArguments(learning_rate=1e-4, weight_decay=0.05, per_device_train_batch_size=TRAIN_B,
                             gradient_accumulation_steps=2)
    model, opt = build_training(cfg, args, num_examples=6 * TRAIN_B, seed=seed)
    step0 = {k: v.detach().clone() for k, v in model.state_dict().items()}
    host = [train_batch(rng, cfg) for _ in range(2)]
    micro = [put_batch(b, args, "cuda") for b in host]
    up_bytes = [sum(t.numel() * t.element_size() for t in m) for m in micro]
    if [tuple(m.mask_labels.shape[:2]) for m in micro] != [(TRAIN_B, TRAIN_T)] * 2 or micro[0].pixel_values.dtype \
            != torch.uint8 or micro[0].mask_labels.dtype != torch.uint8:
        raise AssertionError(f"put_batch: {[tuple(m.mask_labels.shape) for m in micro]}, not packed and compacted")

    # The compacted, packed micro-step against the padded float one, from the same weights.
    stack = build_from_packed("map_10channel_case2", torch.from_numpy(host[0].pixel_values).cuda(), pp)
    padded = put_batch(Batch(stack.cpu().numpy(), host[0].mask_labels, host[0].class_labels, host[0].valid),
                       TrainingArguments(compact_instances=False, pack_targets=False), "cuda")
    original = losses._uniform
    losses._uniform = slot_stable_uniform((TRAIN_B, TRAIN_T_MAX, int(cfg.train_num_points * cfg.oversample_ratio)))
    readings = []
    try:
        for b in (micro[0], padded):
            model.load_state_dict(step0)
            loss, _ = micro_step(model, opt, b, torch.Generator(device="cuda").manual_seed(seed), pp)
            readings.append((loss.item(), global_norm([p.grad for p in model.parameters() if p.grad is not None])
                             .item()))
            opt.zero_grad(set_to_none=True)
    finally:
        losses._uniform = original
    model.load_state_dict(step0)
    (lc, nc), (lp, np_) = readings
    rel = (abs(lc - lp) / abs(lp), abs(nc - np_) / abs(np_))
    log(f"train full: compacted (16 slots) and packed micro-step vs padded (32 slots) float one, same weights and "
        f"points: loss {lc:.7f} / {lp:.7f}, grad norm {nc:.6f} / {np_:.6f}, relative {rel[0]:.2e} / {rel[1]:.2e} "
        f"(tol {TRAIN_FULL_RTOL:g})")
    if not max(rel) <= TRAIN_FULL_RTOL:
        raise AssertionError(f"compacted and padded micro-steps differ: {rel}")

    gen = torch.Generator(device="cuda").manual_seed(seed)
    expected = TRAIN_LAUNCHES
    steady = []
    torch.cuda.reset_peak_memory_stats()
    for step in range(3):
        times, losses_ = [], []
        for i, b in enumerate(micro):
            K.reset_launches()
            (loss, _), t = _timed(lambda: micro_step(model, opt, b, gen, pp))
            _launch_check(f"train full step {step} micro-batch {i}", expected)
            times.append(t)
            losses_.append(loss.item())
        norm, t_apply = _timed(lambda: apply_step(opt, len(micro)))
        norm = norm.item()
        if not (np.isfinite(losses_).all() and np.isfinite(norm)):
            raise AssertionError(f"train full step {step}: losses {losses_}, grad norm {norm}")
        total = sum(times) + t_apply
        if step:
            steady.append(total)
        log(f"train full step {step}: {total:.2f} ms (micro-steps {times[0]:.2f} + {times[1]:.2f}, apply "
            f"{t_apply:.2f}), losses {[round(x, 6) for x in losses_]}, mean-gradient norm {norm:.6f}, "
            f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log(f"train full: {up_bytes} bytes uploaded per micro-batch (uint8 frames {micro[0].pixel_values.numel()} B, "
        f"bit-packed masks {micro[0].mask_labels.numel()} B of 16 slots), 6 K1 + 9 K3 forward and 6 + 9 backward "
        f"launches per micro-batch; steady optimizer steps {[round(x, 2) for x in steady]} ms, "
        f"{[int(v.sum()) for v in (host[0].valid, host[1].valid)]} real instances per micro-batch")
    return step0, micro, steady


def run_bf16_step(seed: int, step0, micro, steady_f32, pp_hw=(480, 640), profile: bool = False) -> None:
    """Phase 13: from the train-full phase's step-0 weights and first micro-batch,
    one optimizer step under the bf16 policy and one in float32: both finite, the
    kernels launched with bfloat16 operands in the bf16 step only, the relative
    gap in loss and gradient norm within BF16_GAP_BOUND; then 3 steady steps of
    each policy, timed, and a fourth bf16 step under the profiler for the
    port's kernels' share of device time (with `profile`, a float32 one too)."""
    import torch

    from rgbdseg_torch.config import ModelConfig, PreprocessConfig
    from rgbdseg_torch.train.arguments import TrainingArguments
    from rgbdseg_torch.train.trainer import build_training, train_step

    cfg = ModelConfig(num_labels=40, version="0.4.0")
    pp = PreprocessConfig(height=pp_hw[0], width=pp_hw[1])
    readings, times, shares = {}, {}, {}
    with launches_by_dtype() as by_dtype:
        for bf16 in (True, False):
            model, opt = build_training(cfg, TrainingArguments(learning_rate=1e-4, weight_decay=0.05, bf16=bf16,
                                                               per_device_train_batch_size=TRAIN_B), 8, seed=seed)
            model.load_state_dict(step0)
            by_dtype.clear()
            gen = torch.Generator(device="cuda").manual_seed(seed)
            loss, _, norm = train_step(model, opt, micro[0], gen, pp)
            readings[bf16] = (loss.item(), norm.item(), dict(by_dtype))
            times[bf16] = [_timed(lambda: train_step(model, opt, micro[i % 2], gen, pp))[1] for i in range(4)][1:]
            if profile or bf16:  # the bf16 step always: its kernels' share of device time
                shares[bf16] = profile_call(f"{'bf16' if bf16 else 'float32'} train step (one micro-batch)",
                                            lambda: train_step(model, opt, micro[0], gen, pp), top=15 if profile else 5)
            del model, opt
    (lb, nb, db), (lf, nf, df) = readings[True], readings[False]
    want = {"bfloat16": {("deformable", "bfloat16"): 6, ("deformable_bwd", "bfloat16"): 6,
                         ("masked_attention", "bfloat16"): 9, ("masked_attention_bwd", "bfloat16"): 9},
            "float32": {("deformable", "float32"): 6, ("deformable_bwd", "float32"): 6,
                        ("masked_attention", "float32"): 9, ("masked_attention_bwd", "float32"): 9}}
    gap = (abs(lb - lf) / abs(lf), abs(nb - nf) / abs(nf))
    log(f"bf16 step: loss {lb:.6f} (float32 {lf:.6f}), grad norm {nb:.6f} (float32 {nf:.6f}); relative gap "
        f"{gap[0]:.3e} / {gap[1]:.3e} (bound {BF16_GAP_BOUND}); launches by operand dtype: bf16 step "
        f"{sorted(db.items())}, float32 step {sorted(df.items())}")
    if db != want["bfloat16"] or df != want["float32"]:
        raise AssertionError(f"bf16 step launches {db}, float32 step {df}; expected {want}")
    if not (all(np.isfinite((lb, nb, lf, nf))) and gap[0] <= BF16_GAP_BOUND[0] and gap[1] <= BF16_GAP_BOUND[1]):
        raise AssertionError(f"bf16 step: gap {gap} outside {BF16_GAP_BOUND}")
    log(f"bf16 step: steady steps of one micro-batch (batch {TRAIN_B}, packed and compacted): bf16 "
        f"{[round(x, 2) for x in times[True]]} ms, float32 {[round(x, 2) for x in times[False]]} ms; steady float32 "
        f"optimizer steps of 2 micro-batches (phase 12) {[round(x, 2) for x in steady_f32]} ms")
    wall, busy, port_ms = shares[True]
    log(f"bf16 step: under the profiler {wall:.2f} ms, device busy {busy:.2f} ms; the port's kernels (bf16 operands) "
        f"{port_ms:.3f} ms = {100 * port_ms / busy:.1f}% of device time, {100 * port_ms / wall:.2f}% of the step")


@contextlib.contextmanager
def launches_by_dtype():
    """{(kernel, operand dtype): launches} while the block runs: each module's
    `launch` wrapped to read the dtype flag its wrapper passes (the last int)."""
    from rgbdseg_torch.ops.kernels import deformable as KD
    from rgbdseg_torch.ops.kernels import masked_attention as KM

    counts = {}

    def counting(original):
        def launch(name, *a, **kw):
            key = (name, "bfloat16" if a[-1] else "float32")
            counts[key] = counts.get(key, 0) + 1
            return original(name, *a, **kw)

        return launch

    originals = KD.launch, KM.launch
    KD.launch, KM.launch = counting(KD.launch), counting(KM.launch)
    try:
        yield counts
    finally:
        KD.launch, KM.launch = originals


def run_finetune(seed: int, out_dir: Path):
    """Phase 15: `finetune_torch.main` end to end on a synthetic set at full
    width, its artifacts, its launches per micro-step and its epoch times; then
    an interrupted run resumed by a fresh `Trainer`. Returns the run's output
    directory and the set's root."""
    import dataclasses
    import shutil

    import torch

    import finetune_torch
    from rgbdseg_torch.config import ModelConfig
    from rgbdseg_torch.data import synthetic
    from rgbdseg_torch.data.pipeline import SegmentationDataset, build_datasets
    from rgbdseg_torch.ops import kernels as K
    from rgbdseg_torch.train import trainer as T
    from rgbdseg_torch.train.arguments import parse_args
    from rgbdseg_torch.train.checkpoints import find_last_checkpoint

    shutil.rmtree(out_dir, ignore_errors=True)
    fx, t_gen = _timed(lambda: synthetic.generate(str(out_dir / "set"), num_train=FT_TRAIN, num_valid=FT_VALID,
                                                  size=(480, 640), seed=seed))
    run = out_dir / "run"
    config = {
        "root_path": fx["root"], "train_json_path": "train.json", "valid_json_path": "valid.json",
        "label2id_path": "label2id.json", "image_height": 480, "image_width": 640, "version": "0.4.0",
        "output_dir": str(run), "num_train_epochs": FT_EPOCHS, "per_device_train_batch_size": FT_B,
        "per_device_eval_batch_size": FT_B, "gradient_accumulation_steps": 1, "learning_rate": 1e-4,
        "seed": seed, "save_strategy": "epoch", "save_total_limit": 1, "do_eval": True,
        "prediction_json_path": str(run / "pred.json"), "gt_json_path": str(run / "gt.json"),
        "comparison_output_dir": str(run / "comparison"),
    }
    config_path = out_dir / "finetune.json"
    config_path.write_text(json.dumps(config))

    # Per micro-step: its launches and loss; per epoch: the train loop's seconds
    # (from asking for the first batch to the last step's end).
    micro, epoch_s = [], []
    orig_micro, orig_batches = T.micro_step, SegmentationDataset.batches

    def counted_micro(*a, **k):
        before = dict(K.LAUNCHES)
        out = orig_micro(*a, **k)
        micro.append(({n: K.LAUNCHES[n] - before[n] for n in K.LAUNCHES}, out[0]))
        return out

    def timed_batches(self, *a, **k):
        t = time.perf_counter()
        yield from orig_batches(self, *a, **k)
        if k.get("shuffle"):
            torch.cuda.synchronize()
            epoch_s.append(time.perf_counter() - t)

    T.micro_step, SegmentationDataset.batches = counted_micro, timed_batches
    try:
        K.reset_launches()
        trainer, t_main = _timed(lambda: finetune_torch.main([str(config_path)]))
        launches = dict(K.LAUNCHES)
        main_micro, main_epochs = list(micro), list(epoch_s)

        names = sorted(os.listdir(run))
        ckpts = [n for n in names if n.startswith("checkpoint-")]
        steps = FT_EPOCHS * FT_TRAIN // FT_B
        if ckpts != [f"checkpoint-{steps}"]:
            raise AssertionError(f"checkpoints {ckpts}; expected checkpoint-{steps} alone (save_total_limit 1)")
        want = ["README.md", "all_results.json", "config.json", "gt.json", "model.safetensors", "pred.json",
                "test_results.json", "train_results.json", "trainer_state.json"]
        if missing := [n for n in want if n not in names]:
            raise AssertionError(f"finetune artifacts missing: {missing} (have {names})")
        history = json.loads((run / "trainer_state.json").read_text())["log_history"]
        n_loss, n_map = sum("loss" in e for e in history), sum("eval_map" in e for e in history)
        pngs = sorted(os.listdir(run / "comparison"))
        if (n_loss, n_map) != (FT_EPOCHS, FT_EPOCHS) or len(pngs) != FT_VALID:
            raise AssertionError(f"trainer_state.json: {n_loss} loss and {n_map} eval_map entries; "
                                 f"{len(pngs)} comparison PNGs")
        if len(main_micro) != steps or any(d != TRAIN_LAUNCHES for d, _ in main_micro):
            raise AssertionError(f"micro-step launches {[d for d, _ in main_micro]}; expected {steps} x {TRAIN_LAUNCHES}")
        losses = [float(x) for _, x in main_micro]
        if not np.isfinite(losses).all():
            raise AssertionError(f"finetune losses {losses}")
        results = json.loads((run / "all_results.json").read_text())
        log(f"finetune: set of {FT_TRAIN} + {FT_VALID} 480x640 frames written in {t_gen / 1e3:.1f} s; "
            f"finetune_torch.main {t_main / 1e3:.1f} s; artifacts {names}, {len(pngs)} comparison PNGs; "
            f"log_history {n_loss} loss and {n_map} eval_map entries; every one of {steps} micro-steps launched "
            f"{TRAIN_LAUNCHES}; all launches {launches}")
        log(f"finetune: epoch losses {[e['loss'] for e in history if 'loss' in e]}, eval_map "
            f"{[round(e['eval_map'], 4) for e in history if 'eval_map' in e]}, test_map {results['test_map']:.4f}, "
            f"train_runtime {results['train_runtime']} s, total_flos {results['total_flos']:.4e}")
        per_step = [t / (FT_TRAIN // FT_B) for t in main_epochs]
        log(f"finetune epochs: {[round(t, 3) for t in main_epochs]} s for {FT_TRAIN // FT_B} steps of batch {FT_B} "
            f"({[round(FT_TRAIN / t, 3) for t in main_epochs]} images/s); an NYUv2 epoch of {NYU_STEPS} steps at "
            f"the last epoch's rate: {per_step[-1] * NYU_STEPS:.1f} s = {per_step[-1] * NYU_STEPS / 3600:.4f} "
            f"GPU hours")

        log_loading_rates(fx)

        # Resume: the same arguments into another directory, without eval (it
        # draws from its own generator and leaves the training state as it was).
        args, targs = parse_args([str(config_path)])
        targs.output_dir, targs.do_eval = str(out_dir / "resume"), False
        train_ds, valid_ds, label2id, id2label = build_datasets(args)
        cfg = ModelConfig(num_labels=len(label2id), version=args.version)
        saved = {}
        first = T.Trainer(cfg, targs, train_ds, valid_ds, id2label)
        save = first._save

        def interrupting_save(output_dir):
            path = save(output_dir)
            saved.update(path=path, step=first.global_step, rng=first.generator.get_state(),
                         model={k: v.detach().clone() for k, v in first.model.state_dict().items()},
                         optimizer=first.optimizer.state_dict())
            raise KeyboardInterrupt  # a run stopped right after its epoch-1 checkpoint

        first._save = interrupting_save
        micro.clear()
        try:
            first.train()
        except KeyboardInterrupt:
            pass
        # A second run of epoch 1 from the same weights and batches: the same bits.
        again1, ran1 = [float(x) for _, x in micro], losses[:steps // FT_EPOCHS]
        log(f"finetune: two runs' epoch-1 micro-step losses equal bit for bit: {again1 == ran1} (largest relative "
            f"difference {max(abs(a - b) / abs(b) for a, b in zip(again1, ran1)):.3e}; {again1} vs {ran1})")
        if again1 != ran1:
            raise AssertionError(f"two runs' epoch-1 losses differ: {again1} vs {ran1}")
        last = find_last_checkpoint(targs.output_dir)
        if last != saved["path"] or saved["step"] != steps // FT_EPOCHS:
            raise AssertionError(f"interrupted run: last checkpoint {last}, saved {saved['path']} at {saved['step']}")
        resumed = T.Trainer(cfg, targs, train_ds, valid_ds, id2label)
        resumed._restore(last)
        got = resumed.optimizer.state_dict()
        same = {
            "parameters and BatchNorm statistics": all(
                torch.equal(v, saved["model"][k]) for k, v in resumed.model.state_dict().items()),
            "moments": got["state"].keys() == saved["optimizer"]["state"].keys() and all(
                torch.equal(m, saved["optimizer"]["state"][n][k]) for n, st in got["state"].items()
                for k, m in st.items()),
            "count": got["count"] == saved["optimizer"]["count"] == saved["step"],
            "CUDA generator state": torch.equal(resumed.generator.get_state(), saved["rng"]),
            "step": resumed.global_step == saved["step"],
        }
        if not all(same.values()):
            raise AssertionError(f"reloaded state differs from the saved one: {same}")
        # The interrupted run's own continuation from the state it saved, in memory:
        # it writes its epoch-2 checkpoint beside the resumed run's, not over it.
        first._save, first.args = save, dataclasses.replace(targs, output_dir=str(out_dir / "straight"))
        epoch2 = {}
        for label, run_epoch2 in (("resumed", lambda: resumed.train(resume_from_checkpoint=last)),
                                  ("uninterrupted", first.train)):
            micro.clear()
            run_epoch2()
            epoch2[label] = [float(x) for _, x in micro]
            if len(micro) != steps // FT_EPOCHS:
                raise AssertionError(f"{label} run's epoch 2 took {len(micro)} micro-steps")
        if resumed.global_step != steps or first.global_step != steps:
            raise AssertionError(f"epoch 2 ended at steps {resumed.global_step} (resumed), {first.global_step}")
        straight, again = (float(np.mean(epoch2[k])) for k in ("uninterrupted", "resumed"))
        main2 = losses[steps // FT_EPOCHS:]
        log(f"finetune resume: checkpoint-{saved['step']} reloaded by a fresh Trainer equal bit for bit "
            f"({', '.join(same)}); epoch-2 mean loss resumed {again:.7f} vs the interrupted run's own continuation "
            f"in memory {straight:.7f}; micro-step losses resumed {epoch2['resumed']}, uninterrupted "
            f"{epoch2['uninterrupted']} (equal bit for bit: {epoch2['resumed'] == epoch2['uninterrupted']}); the "
            f"finetune run's epoch 2 (another run, which also evaluated after epoch 1) {main2}, equal to them bit "
            f"for bit: {main2 == epoch2['resumed']}")
        # the same state, batches and generator states: a resumed run is the run it continues
        if epoch2["resumed"] != epoch2["uninterrupted"]:
            raise AssertionError(f"epoch 2: resumed {epoch2['resumed']}, uninterrupted {epoch2['uninterrupted']}")
        del resumed, first, trainer
    finally:
        T.micro_step, SegmentationDataset.batches = orig_micro, orig_batches
    return run, Path(fx["root"])


def log_loading_rates(fx: dict) -> None:
    """The train set's loading time per image on this host, uncached, with 4
    worker threads: raw frames (device_channels) and float stacks built on the
    host, each with torch's default intra-op pool and with one thread per
    worker (workers x threads within the cores)."""
    import torch

    from rgbdseg_torch.config import PreprocessConfig
    from rgbdseg_torch.data.pipeline import SegmentationDataset, load_meta

    default_threads, rates = torch.get_num_threads(), []
    try:
        for threads in (default_threads, 1):
            torch.set_num_threads(threads)
            for raw in (True, False):
                ds = SegmentationDataset(load_meta(fx["train"], fx["root"]), "0.4.0",
                                         PreprocessConfig(height=480, width=640), device_channels=raw, cache=False)
                t = time.perf_counter()
                for _ in ds.batches(FT_B, num_workers=4):
                    pass
                rates.append(f"{'raw frames' if raw else 'host stacks'} with {threads} intra-op threads "
                             f"{(time.perf_counter() - t) * 1e3 / len(ds):.1f}")
    finally:
        torch.set_num_threads(default_threads)
    log(f"finetune data loading ms per 480x640 image, uncached, 4 workers, {os.cpu_count()} cores: "
        + "; ".join(rates))


def run_predict_entry(run: Path, set_root: Path) -> None:
    """Phase 16: `predict_torch.main` on a raw 480x640 PNG pair, from the training
    checkpoint and from the HF export of phase 15: logits equal bit for bit,
    6 K1 and 9 K3 launches each, the overlay written."""
    import torch

    import predict_torch
    from rgbdseg_torch.data.image_io import read_png
    from rgbdseg_torch.inference.predictor import Predictor
    from rgbdseg_torch.ops import kernels as K

    logits = []
    forward = Predictor._forward

    def keep(self, x):
        out = forward(self, x)
        logits.append(tuple(t.detach().clone() for t in out))
        return out

    image, depth = str(set_root / "images" / f"{FT_TRAIN}.png"), str(set_root / "depth" / f"{FT_TRAIN}.png")
    common = ["--version", "0.4.0", "--num_labels", "3", "--image", image, "--depth", depth,
              "--image_height", "480", "--image_width", "640"]
    steps = FT_EPOCHS * FT_TRAIN // FT_B
    results = []
    Predictor._forward = keep
    try:
        for name, source in (("checkpoint", ["--checkpoint", str(run / f"checkpoint-{steps}")]),
                             ("hf_checkpoint", ["--hf_checkpoint", str(run)])):
            overlay = str(run / f"overlay_{name}.png")
            K.reset_launches()
            res, ms = _timed(lambda: predict_torch.main(source + common + ["--save", overlay]))
            _launch_check(f"predict_torch --{name}", SERVE_LAUNCHES)
            if read_png(overlay).shape != (480, 640, 3):
                raise AssertionError(f"predict_torch --{name}: overlay {read_png(overlay).shape}")
            results.append(res)
            log(f"predict entry --{name}: {ms:.1f} ms (weights loaded, one frame served, overlay written), "
                f"{len(res['segments_info'])} segments at threshold 0.5, launches {dict(K.LAUNCHES)}")
    finally:
        Predictor._forward = forward
    (c0, m0), (c1, m1) = logits
    if not (torch.equal(c0, c1) and torch.equal(m0, m1)):
        raise AssertionError(f"logits from the checkpoint and from the HF export differ: class "
                             f"{(c0 - c1).abs().max().item():.3e}, mask {(m0 - m1).abs().max().item():.3e}")
    if results[0]["segments_info"] != results[1]["segments_info"]:
        raise AssertionError("segments from the checkpoint and from the HF export differ")
    log(f"predict entry: class {tuple(c0.shape)} and mask {tuple(m0.shape)} logits from the training checkpoint "
        f"and from the HF export equal bit for bit")


# The versions phase (17): the 13 ablation versions. The four families' train
# steps (0.0.7: intrinsics normals; 0.1.1: dual backbone and FeatureFuser;
# 0.2.0: CSF; 0.3.0: backbone ratio), two of them also step 0 against the CPU.
TRAIN_VERSIONS = ("0.0.7", "0.1.1", "0.2.0", "0.3.0")
STEP0_VERSIONS = ("0.0.7", "0.1.1")


def version_frames(rng, version: str, h: int, w: int, boxes: int = 4):
    """(the raw uint8 frames a record of `version` lists, the instance map): the
    RGB and the depth (a gray plane with 1% holes, as its PNG reads in RGB); for
    0.3.0 a third frame, the depth's gradient image (its Sobel magnitude,
    saturated to uint8); for 0.2.0 eight augmentation frames, the depth rescaled
    as `data/synthetic.py` writes them."""
    from rgbdseg_torch.data.depth_features import compute_depth_gradient
    from rgbdseg_torch.data.synthetic import convert_scale_abs
    from rgbdseg_torch.versions import get as get_version

    rgb, depth, inst = synthetic_frame(rng, h, w, boxes)
    frames = [rgb, depth_rgb(depth)]
    map_fn = get_version(version).map_fn
    if map_fn == "map_10channel_case1":
        frames.append(depth_rgb(np.clip(compute_depth_gradient(depth), 0, 255).astype(np.uint8)))
    elif map_fn == "map_30channel":
        frames += [depth_rgb(convert_scale_abs(depth, 1.0 + 0.1 * m, 5 * m)) for m in range(8)]
    return frames, inst


def masked_forward(model, x, masks=None):
    """((class, mask) logits on the CPU, each decoder layer's attention mask as
    (mask logits, all-blocked rows) on the CPU) of an eval forward; with
    `masks`, each layer's attention mask is replaced by the given one."""
    own = []
    handle = model.transformer_module.mask_predictor.register_forward_hook(mask_hook(own, masks))
    try:
        out = model(x)
    finally:
        handle.remove()
    return (out.class_queries_logits.cpu(), out.masks_queries_logits.cpu()), own


def serve_version(seed: int, rng, version: str, cmp_hw) -> dict:
    """3 `predict_example` requests of the full-width model of `version` through
    the kernels (raw 720x1280 frames built on the card; the host-only layouts
    from 480x640 frames by the host map function), 6 K1 and 9 K3 each; the
    card-built stack of raw `cmp_hw` frames against the host map function's,
    bit for bit; the logits of that stack on the card against the CPU copy's,
    on the CPU's own decoder attention masks and on the GPU's, each within
    SLICE_RTOL, with the count of mask entries whose blocked test differs."""
    import torch

    from rgbdseg_torch.config import ModelConfig, PreprocessConfig
    from rgbdseg_torch.data import device_preprocess as DP
    from rgbdseg_torch.data import registry as R
    from rgbdseg_torch.inference.predictor import Predictor
    from rgbdseg_torch.ops import kernels as K
    from rgbdseg_torch.versions import get as get_version

    cfg = ModelConfig(num_labels=40, version=version)
    map_fn = get_version(version).map_fn
    on_card = DP.supported(map_fn)
    (pred, t_build) = _timed(lambda: Predictor(cfg, device="cuda", seed=seed,
                                              preprocess=PreprocessConfig(height=480, width=640)))
    req_hw = (720, 1280) if on_card else (480, 640)
    requests = [version_frames(rng, version, *req_hw)[0] for _ in range(3)]
    ms = []
    for i, frames in enumerate(requests):
        K.reset_launches()
        res, t = _timed(lambda: pred.predict_example({"image": frames}, threshold=0.0))
        _launch_check(f"versions {version} request {i}", dict(SERVE_LAUNCHES, **NO_EDSAM))
        ms.append(t)
    upload, launches = pred.last_upload_bytes, dict(K.LAUNCHES)

    # Where a request's time goes: the stack built (on the card or the host), the forward, post-processing.
    frames = requests[0]
    if on_card:
        width = DP.packed_width(map_fn)
        flat_np = np.concatenate([f.reshape(-1) for f in frames[: width // 3]])

        def build():
            flat = torch.from_numpy(flat_np).to("cuda")
            views = [flat[i * frames[0].size:(i + 1) * frames[0].size].reshape(1, *frames[0].shape)
                     for i in range(width // 3)] + [None, None]
            return DP.build_pixels(map_fn, views[0], views[1], pred.preprocess, views[2])
    else:
        def build():
            pix = R.MAP_FUNCTIONS[map_fn]({"image": frames}, pred.preprocess)[0]
            return torch.from_numpy(pix[None]).to("cuda")
    from rgbdseg_torch.inference.postprocess import post_process_instance_segmentation

    pix, t_stack = _timed(build)
    (cls, masks), t_fwd = _timed(lambda: pred._forward(pix))
    _, t_post = _timed(lambda: post_process_instance_segmentation(cls, masks, threshold=0.0,
                                                                  target_sizes=[(480, 640)]))

    # The card against the CPU on one stack of raw cmp_hw frames.
    pp = PreprocessConfig(height=cmp_hw[0], width=cmp_hw[1])
    frames = version_frames(rng, version, *cmp_hw)[0]
    host = R.MAP_FUNCTIONS[map_fn]({"image": frames}, pp)[0]
    stack = torch.from_numpy(host[None])  # numpy's a[None]: batch stride 0
    bitwise = "host-built"
    if on_card:
        width = DP.packed_width(map_fn)
        packed = torch.from_numpy(np.concatenate(frames[: width // 3], axis=-1)[None]).to("cuda")
        card = DP.build_from_packed(map_fn, packed, pp).cpu()
        if not torch.equal(card, stack):
            raise AssertionError(f"versions {version}: the card-built stack differs from the host's by "
                                 f"{(card - stack).abs().max().item()}")
        bitwise = "card = CPU bit for bit"
    with torch.no_grad():
        gpu, gpu_masks = masked_forward(pred.model, stack.to("cuda"))
        if version == "0.1.1":  # one dual-backbone stack in two layouts: equal logits
            full = [t.cpu() for t in pred._forward(stack.to("cuda").clone(memory_format=torch.contiguous_format))]
            if not all(torch.equal(a, b) for a, b in zip(gpu, full)):
                raise AssertionError("versions 0.1.1: one stack in two layouts gave different logits")
        cpu_model = pred.model.__class__(cfg)
        cpu_model.load_state_dict({k: v.cpu() for k, v in pred.model.state_dict().items()}, strict=True)
        cpu_model.eval()
        t = time.perf_counter()
        cpu, cpu_masks = masked_forward(cpu_model, stack)
        cpu_s = time.perf_counter() - t
        same, _ = masked_forward(cpu_model, stack, gpu_masks)
    # The decoder blocks a key where a mask logit is < 0: a logit that sits at 0
    # can fall on either side on the two devices and move the later layers.
    flipped = [(((ga < 0) & ~gb[..., None]) != ((ca < 0) & ~cb[..., None]), ga, ca)
               for (ga, gb), (ca, cb) in zip(gpu_masks[:-1], cpu_masks[:-1])]
    flips = sum(f.sum().item() for f, _, _ in flipped)
    # the largest |mask logit| of a flipped entry, on the GPU and on the CPU
    band = (max((ga[f].abs().max().item() for f, ga, _ in flipped if f.any()), default=0.0),
            max((ca[f].abs().max().item() for f, _, ca in flipped if f.any()), default=0.0))
    errs = []
    for i, name in enumerate(("class", "mask")):
        if not torch.isfinite(gpu[i]).all():
            raise AssertionError(f"versions {version}: non-finite {name} logits on the GPU")
        diff, scale = (gpu[i] - cpu[i]).abs().max().item(), cpu[i].abs().max().item()
        diff_same = (gpu[i] - same[i]).abs().max().item()
        if not (diff <= SLICE_RTOL * max(1.0, scale) and diff_same <= SLICE_RTOL * max(1.0, scale)):
            raise AssertionError(f"versions {version}: {name} logits GPU vs CPU differ by {diff} ({diff_same} on "
                                 f"the GPU's attention masks; max |logit| {scale}; {flips} attention-mask entries "
                                 f"differ, their |mask logit| at most {band[0]:.3e} on the GPU, {band[1]:.3e} on "
                                 f"the CPU)")
        errs.append((diff, scale, diff_same))
    row = {"version": version, "map_fn": map_fn, "on_card": on_card, "ms": ms, "upload": upload,
           "stages": {"stack": t_stack, "forward": t_fwd, "post_process": t_post},
           "launches": launches, "errs": errs, "flips": flips, "cmp_hw": cmp_hw, "bitwise": bitwise,
           "params": sum(p.numel() for p in pred.model.parameters()), "build_s": t_build / 1e3, "cpu_s": cpu_s}
    log(f"versions {version} ({map_fn}, {'built on the card from 720x1280' if on_card else 'host-built from 480x640'}"
        f"): request ms {[round(x, 2) for x in ms]}, steady {round(sum(ms[1:]) / 2, 2)}, {upload} bytes up, "
        f"launches {launches} per request; stages ms stack {t_stack:.2f} forward {t_fwd:.2f} post "
        f"{t_post:.2f}; GPU vs CPU at {cmp_hw[0]}x{cmp_hw[1]} (class, mask) max_abs_diff "
        f"{errs[0][0]:.3e}, {errs[1][0]:.3e} of max |logit| {errs[0][1]:.3e}, {errs[1][1]:.3e} (tol {SLICE_RTOL:g} x "
        f"max(1, max |logit|)); {flips} attention-mask entries differ (|mask logit| at most {band[0]:.1e} on the "
        f"GPU, {band[1]:.1e} on the CPU), on the GPU's masks {errs[0][2]:.3e}, "
        f"{errs[1][2]:.3e}; stack {bitwise}; {row['params']} parameters, built {row['build_s']:.1f} s, "
        f"CPU forward {cpu_s:.1f} s")
    del pred
    torch.cuda.empty_cache()
    return row


def train_version(seed: int, rng, version: str) -> None:
    """One `micro_step` + `apply_step` of the full-width model of `version` at
    batch 2 of raw 480x640 frames (packed uint8, built in the step; 0.2.0's
    host-only stacks as float32), 6 K1 and 9 K3 forward and backward; loss,
    gradient norm and every gradient finite (0.0.7's depth has 1% holes, so its
    normals have NaN points, detached); 0.0.7's intrinsics predictor unchanged
    bit for bit. For STEP0_VERSIONS also step 0 against the CPU."""
    import torch

    from rgbdseg_torch.config import ModelConfig, PreprocessConfig
    from rgbdseg_torch.data import device_preprocess as DP
    from rgbdseg_torch.data import registry as R
    from rgbdseg_torch.ops import kernels as K
    from rgbdseg_torch.train.arguments import TrainingArguments
    from rgbdseg_torch.train.trainer import TrainBatch, apply_step, build_training, micro_step
    from rgbdseg_torch.versions import get as get_version

    cfg = ModelConfig(num_labels=40, version=version)
    map_fn = get_version(version).map_fn
    pp = PreprocessConfig(height=480, width=640)
    args = TrainingArguments(learning_rate=1e-4, weight_decay=0.05, per_device_train_batch_size=TRAIN_B)
    model, opt = build_training(cfg, args, num_examples=TRAIN_B, seed=seed)
    step0 = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    raw, stacks, masks = [], [], []
    for _ in range(TRAIN_B):
        frames, inst = version_frames(rng, version, 480, 640, boxes=TRAIN_T)
        width = DP.packed_width(map_fn) if DP.supported(map_fn) else 0
        raw.append(np.concatenate(frames[: width // 3], axis=-1) if width else None)
        stacks.append(R.MAP_FUNCTIONS[map_fn]({"image": frames}, pp)[0])
        masks.append(np.stack([inst == i + 1 for i in range(TRAIN_T)]).astype(np.float32))
    masks = np.stack(masks)
    valid = masks.any(axis=(2, 3))
    classes = rng.randint(0, cfg.num_labels, (TRAIN_B, TRAIN_T))
    pix = np.stack(raw) if raw[0] is not None else np.stack(stacks)
    batch = TrainBatch(*(torch.from_numpy(np.ascontiguousarray(a)).to("cuda") for a in (pix, masks, classes, valid)))
    gen = torch.Generator(device="cuda").manual_seed(seed)
    opt.zero_grad(set_to_none=True)
    K.reset_launches()
    (loss, _), t_micro = _timed(lambda: micro_step(model, opt, batch, gen, pp))
    grads = {n: p.grad for n, p in model.named_parameters() if p.grad is not None}
    bad = [n for n, g in grads.items() if not torch.isfinite(g).all()]
    norm, t_apply = _timed(lambda: apply_step(opt, 1))
    _launch_check(f"versions {version} train step", dict(TRAIN_LAUNCHES, **NO_EDSAM))
    loss, norm = loss.item(), norm.item()
    if bad or not (np.isfinite(loss) and np.isfinite(norm)):
        raise AssertionError(f"versions {version} train step: loss {loss}, norm {norm}, non-finite {bad[:5]}")
    frozen = ""
    if version == "0.0.7":
        names = [n for n in step0 if n.startswith("pixel_level_module.intrinsics_predictor.")]
        params = dict(model.named_parameters())
        moved = [n for n in names if not torch.equal(params[n].detach().cpu(), step0[n])]
        if not names or moved or any(params[n].grad is not None for n in names):
            raise AssertionError(f"versions 0.0.7: the intrinsics predictor moved: {moved[:5]}")
        frozen = f"; intrinsics predictor ({len(names)} tensors) unchanged bit for bit"
    log(f"versions {version} train step (batch {TRAIN_B}, {'packed raw frames' if raw[0] is not None else 'host stacks'}"
        f"): micro-step {t_micro:.2f} ms, apply {t_apply:.2f} ms, loss {loss:.6f}, grad norm {norm:.6f}, "
        f"{len(grads)} gradients finite, launches {dict(K.LAUNCHES)}{frozen}")
    if version in STEP0_VERSIONS:
        host = TrainBatch(*(torch.from_numpy(np.ascontiguousarray(a)) for a in (np.stack(stacks), masks, classes, valid)))
        step0_gpu_vs_cpu(step0, host, version, own_masks=False)
    del model, opt
    torch.cuda.empty_cache()


def run_versions(seed: int, rng) -> None:
    """Phase 17: the 13 ablation versions at full width, served and trained."""
    from rgbdseg_torch import versions as V

    for version in sorted(set(V.REGISTRY) - {"0.0.0", "0.4.0"}):
        serve_version(seed, rng, version, (480, 640) if version in TRAIN_VERSIONS else VERSIONS_CMP_HW)
    for version in TRAIN_VERSIONS:
        train_version(seed, rng, version)


# The parallel phase (18). The card's machine has one H100 and NCCL refuses
# two ranks on one device, so the NCCL path runs at world size 1 and the
# two-rank paths run as two processes sharing the card over Gloo, which carries
# all_reduce and broadcast for CUDA tensors: all that DDP, the Megatron pairing
# and the port's gathers use.
PARALLEL_TIMEOUT_S = 400  # the two child processes together
# Two processes against one at the global batch: phase 7's bounds (loss,
# gradient norm, worst kernel-fed leaf, relative) and the BatchNorm running
# statistics (absolute; they are O(1)). The eval: the loss relative, every
# mAP key within PARALLEL_MAP_TOL.
PARALLEL_BN_TOL, PARALLEL_EVAL_RTOL, PARALLEL_MAP_TOL = 1e-5, 1e-5, 1e-6
TP_HEADS = MODEL_NH // 2  # one rank's heads under model_parallel_size 2


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


class BatchSet:
    """Eval batches as the dataset `Trainer.evaluate` reads: `batches(b)` yields
    them in their order (b must be their size), `preprocess` the 480x640 one."""

    def __init__(self, batches):
        from rgbdseg_torch.config import PreprocessConfig

        self.stored, self.preprocess, self.pack_gt = batches, PreprocessConfig(height=480, width=640), True

    def __len__(self):
        return sum(b.pixel_values.shape[0] for b in self.stored)

    def batches(self, batch_size, num_workers=0, **_):
        if any(b.pixel_values.shape[0] != batch_size for b in self.stored):
            raise ValueError(f"BatchSet holds batches of {self.stored[0].pixel_values.shape[0]}, not {batch_size}")
        return iter(self.stored)


def _parallel_args(**kw):
    from rgbdseg_torch.train.arguments import TrainingArguments

    # Eval without target compaction on both sides: it is single-process only,
    # and its slot count would change the shapes of the loss's point draws.
    return TrainingArguments(learning_rate=1e-4, weight_decay=0.05, compact_instances=False, **kw)


def _step_record(model, net, opt, batch, gen, pp, leaves, mesh=None, probe=lambda: (0, 0.0)) -> dict:
    """One micro_step + apply_step of `net`: loss, gradient norm, the kernel-fed
    gradients (a shard's gathered to its full tensor), BatchNorm statistics,
    launches, micro-step and apply ms, and the step's share of `probe()`'s
    running (calls, ms) of blocking collectives (the gathers here left out)."""
    import torch

    from rgbdseg_torch.ops import kernels as K
    from rgbdseg_torch.parallel.sharding import gather_shard
    from rgbdseg_torch.train.trainer import apply_step, micro_step

    K.reset_launches()
    c0 = probe()
    (loss, _), t_micro = _timed(lambda: micro_step(net, opt, batch, gen, pp))
    c1 = probe()
    launches = dict(K.LAUNCHES)
    params = dict(model.named_parameters())
    shards = getattr(model, "tp_shards", {})
    grads = {n: (params[n].grad if n not in shards else gather_shard(params[n].grad, shards[n], mesh)).cpu()
             for n in leaves if params[n].grad is not None}
    bn = {k: v.detach().cpu().clone() for k, v in model.state_dict().items() if "running_" in k}
    c2 = probe()
    norm, t_apply = _timed(lambda: apply_step(opt, 1))
    c3 = probe()
    return {"loss": loss.item(), "norm": norm.item(), "grads": grads, "bn": bn, "launches": launches,
            "ms": (t_micro, t_apply), "rng": gen.get_state().cpu(),
            "collectives": (c1[0] - c0[0] + c3[0] - c2[0], c1[1] - c0[1] + c3[1] - c2[1])}


def _recording_matcher(record: list, given=None, rows=slice(None)):
    """A stand-in for the criterion's `hungarian_batch`: it records each call's
    assignment (num_layers, B, T) and, with `given`, returns the given one's rows."""
    import torch

    from rgbdseg_torch.ops import matcher

    def hungarian(cost):
        own = matcher.hungarian_batch(cost)
        record.append(own.cpu())
        if given is None:
            return own
        return given[len(record) - 1][:, rows].to(own.device)

    return hungarian


def run_parallel_nccl(seed: int, step0, batch, pp, cfg, device: str = "cuda", backend: str = "nccl",
                      card: str = "") -> dict:
    """Phase 18a: NCCL at world size 1, in this process (a TCP store on
    localhost): `make_mesh(1)` and one DDP-wrapped full-width 0.4.0 optimizer
    step on phase 12's packed batch, against the plain step from the same
    weights and generator seed. Bit for bit: the parameters after DDP's
    construction, the loss, the BatchNorm statistics, the generator's state,
    and DDP's reduced gradients against the bucket's local ones (DDP divides by
    1). A train step repeats bit for bit (phase 6b), so the gradients, and the
    parameters and moments after the update, of the DDP step and of a second
    plain step must equal the plain step's bit for bit: 0 differ for both.
    Returns the DDP step's launches."""
    import copy

    import torch
    import torch.distributed as dist
    from torch.distributed.algorithms.ddp_comm_hooks import default_hooks

    from rgbdseg_torch.models.mask2former import Mask2FormerRGBD
    from rgbdseg_torch.parallel.mesh import make_mesh
    from rgbdseg_torch.train.trainer import distribute, make_optimizer

    base = Mask2FormerRGBD(cfg)
    base.load_state_dict(step0)
    base.to(device).train()
    args = _parallel_args(per_device_train_batch_size=TRAIN_B)
    everything = [n for n, _ in base.named_parameters()]
    dist.init_process_group(backend, init_method=f"tcp://localhost:{_free_port()}", world_size=1, rank=0)
    try:
        mesh = make_mesh(1, device=device)
        runs = {}
        for label in ("plain", "ddp", "plain again"):
            model = copy.deepcopy(base)
            net, local = model, {}
            if label == "ddp":
                net, _ = distribute(model, mesh, ddp=True)
                if not all(torch.equal(a, b) for a, b in zip(model.state_dict().values(), base.state_dict().values())):
                    raise AssertionError("DDP's construction changed the weights at world size 1")

                def keep_local(state, bucket):  # the bucket's gradients before the reduce
                    local.update({id(p): g.clone() for p, g in zip(bucket.parameters(), bucket.gradients())})
                    return default_hooks.allreduce_hook(mesh.data_group, bucket)

                net.register_comm_hook(None, keep_local)
            opt = make_optimizer(model, args, 8)
            names = {n: id(p) for n, p in model.named_parameters()}
            rec = _step_record(model, net, opt, batch, torch.Generator(device=device).manual_seed(seed), pp,
                               everything)
            if label == "ddp":
                same = sum(torch.equal(g, local[names[n]].cpu()) for n, g in rec["grads"].items())
                if same != len(rec["grads"]):
                    raise AssertionError(f"DDP's reduce at world size 1 changed {len(rec['grads']) - same} of "
                                         f"{len(rec['grads'])} gradients")
                rec["reduce_identity"] = same
            rec["params"] = {n: p.detach().cpu() for n, p in model.named_parameters()}
            rec["moments"] = opt.state_dict()["state"]
            runs[label] = rec
    finally:
        dist.destroy_process_group()
    plain, ddp, again = runs["plain"], runs["ddp"], runs["plain again"]

    def spread(a, b):
        """(tensors that differ, the largest relative difference); the names must agree."""
        if set(a) != set(b):
            raise AssertionError(f"parallel (a): {len(set(a) ^ set(b))} names differ between the runs")
        diff = [((a[n] - b[n]).abs().max() / b[n].abs().max().clamp(min=1e-30)).item() for n in b]
        return sum(d > 0 for d in diff), max(diff)

    exact = {"loss": ddp["loss"] == plain["loss"], "rng": torch.equal(ddp["rng"], plain["rng"]),
             "bn": all(torch.equal(ddp["bn"][k], v) for k, v in plain["bn"].items())}
    g_ddp, g_again = spread(ddp["grads"], plain["grads"]), spread(again["grads"], plain["grads"])
    p_ddp, p_again = spread(ddp["params"], plain["params"]), spread(again["params"], plain["params"])
    moments = lambda r: {f"{n}.{k}": v for n, st in r["moments"].items() for k, v in st.items()}  # noqa: E731
    m_ddp, m_again = spread(moments(ddp), moments(plain)), spread(moments(again), moments(plain))
    log(f"parallel (a) {backend} world size 1, DDP step vs plain step: loss {ddp['loss']:.7f} / {plain['loss']:.7f}, "
        f"bitwise loss {exact['loss']}, generator {exact['rng']}, BatchNorm statistics {exact['bn']}; DDP's reduce "
        f"left {ddp['reduce_identity']} bucket gradients bit for bit; gradient leaves that differ (max rel): DDP "
        f"{g_ddp[0]} ({g_ddp[1]:.2e}), a second plain step {g_again[0]} ({g_again[1]:.2e}); parameters DDP "
        f"{p_ddp[0]} ({p_ddp[1]:.2e}) / plain {p_again[0]} ({p_again[1]:.2e}); moments DDP {m_ddp[0]} "
        f"({m_ddp[1]:.2e}) / plain {m_again[0]} ({m_again[1]:.2e}); step ms (micro + apply) DDP "
        f"{ddp['ms'][0]:.2f} + {ddp['ms'][1]:.2f}, plain {plain['ms'][0]:.2f} + {plain['ms'][1]:.2f} [{card}]")
    if not all(exact.values()):
        raise AssertionError(f"DDP at world size 1 is not the plain step: {exact}")
    for what, (d, _), (a, _) in (("gradients", g_ddp, g_again), ("parameters", p_ddp, p_again),
                                 ("moments", m_ddp, m_again)):
        if a or d:
            raise AssertionError(f"{what}: a second plain step differs from the first in {a}, the DDP step in {d}")
    return ddp["launches"]


def parallel_reference(seed: int, step0, batch, pp, cfg, device: str = "cuda") -> dict:
    """The one-process step of phases 18b and 18c at the global batch (2), from
    phase 12's step-0 weights, generator seed and packed batch: its loss, norm,
    kernel-fed gradients, BatchNorm statistics, and the decoder's attention
    masks and the matcher's assignments, which the two-process runs take as
    their own (the shared decisions)."""
    import torch

    from rgbdseg_torch.models.mask2former import Mask2FormerRGBD
    from rgbdseg_torch.ops import losses
    from rgbdseg_torch.train.trainer import make_optimizer

    model = Mask2FormerRGBD(cfg)
    model.load_state_dict(step0)
    model.to(device).train()
    masks, assignments = [], []
    model.transformer_module.mask_predictor.register_forward_hook(mask_hook(masks))
    original = losses.hungarian_batch
    losses.hungarian_batch = _recording_matcher(assignments)
    try:
        rec = _step_record(model, model, make_optimizer(model, _parallel_args(per_device_train_batch_size=TRAIN_B), 8),
                           batch, torch.Generator(device=device).manual_seed(seed), pp, kernel_fed_leaves(cfg))
    finally:
        losses.hungarian_batch = original
    rec.update(masks=masks, assignments=assignments)
    return rec


def parallel_child(work: Path, seed: int) -> int:
    """The child process of phase 18 (one of two sharing the card, Gloo): (b)
    dp=2, batch 1 per rank; (c) dp=1 x mp=2, the whole batch on each rank at 4
    heads; (d) `Trainer.evaluate` at a global batch of 2, by the device-stats
    route and then the host mask route. The model's config,
    the device, the batch, the shared decisions and the eval batches come from
    `work`/reference.pt; it writes its readings to child{rank}.pt there."""
    import logging

    import torch
    import torch.distributed as dist
    from torch.distributed.algorithms.ddp_comm_hooks import default_hooks

    from rgbdseg_torch.config import ModelConfig
    from rgbdseg_torch.models import pixel_decoder, transformer_decoder
    from rgbdseg_torch.models.mask2former import Mask2FormerRGBD
    from rgbdseg_torch.ops import kernels as K
    from rgbdseg_torch.ops import losses
    from rgbdseg_torch.parallel.mesh import make_mesh
    from rgbdseg_torch.parallel.multihost import host_row_range, initialize
    from rgbdseg_torch.parallel.sharding import full_state_dict
    from rgbdseg_torch.train.optim import AdamW
    from rgbdseg_torch.train.trainer import TrainBatch, Trainer, distribute, make_optimizer, set_matmul_precision
    from rgbdseg_torch.utils.weights import init_weights

    set_matmul_precision("float32")  # TF32 off, cuDNN's deterministic algorithms, as the Trainer sets them
    ref = torch.load(work / "reference.pt", weights_only=False)
    cfg, device = ModelConfig.from_json(ref["cfg"]), ref["device"]
    initialize(backend="gloo", device=device)
    rank = dist.get_rank()
    pp = BatchSet([]).preprocess

    # Time inside collectives: the blocking all-reduces on the host clock (the
    # model's, the loss's, the norm's; waiting for the other rank included), and
    # DDP's bucket all-reduces from issue to completion (they overlap the backward).
    sync_ms, sync_bytes, bucket_ms = [], [], []
    original_all_reduce = dist.all_reduce

    def timed_all_reduce(*a, **kw):
        if kw.get("async_op"):
            return original_all_reduce(*a, **kw)
        t = time.perf_counter()
        out = original_all_reduce(*a, **kw)
        sync_ms.append((time.perf_counter() - t) * 1e3)
        sync_bytes.append(a[0].numel() * a[0].element_size())
        return out

    dist.all_reduce = timed_all_reduce
    heads = set()

    # Under model parallelism, the replicated gradients as this rank computed
    # them, against rank 0's, before the optimizer's model-group mean:
    # (elements that differ, elements).
    replicated = []
    original_average = AdamW._average_replicated

    def compared_average(self, params):
        flat = torch.cat([p.grad.reshape(-1) for p in params
                          if p.grad is not None and self.names[p] not in self.sharded])
        theirs = flat.clone()
        dist.broadcast(theirs, src=0, group=self.model_group)
        replicated.append((int((theirs != flat).sum().item()), flat.numel()))
        return original_average(self, params)

    AdamW._average_replicated = compared_average

    def heads_of(fn, axis):
        def wrapped(*a, **kw):
            heads.add((fn.__name__, a[0].shape[axis]))
            return fn(*a, **kw)

        return wrapped

    results = {"rank": rank}
    for key, model_parallel in (("dp", 1), ("tp", 2)):
        mesh = make_mesh(2, model_parallel, device=device)
        model = init_weights(Mask2FormerRGBD(cfg), seed).to(mesh.device).train()
        net, blocks = distribute(model, mesh)
        if key == "dp":
            def timed_hook(state, bucket):
                t = time.perf_counter()
                return default_hooks.allreduce_hook(mesh.data_group, bucket).then(
                    lambda f: (bucket_ms.append((time.perf_counter() - t) * 1e3), f.value())[1])

            net.register_comm_hook(None, timed_hook)
        start, stop = host_row_range(TRAIN_B, mesh)
        batch = TrainBatch(*(t[start:stop].to(mesh.device) for t in ref["batch"]))
        own, assignments = [], []
        model.transformer_module.mask_predictor.register_forward_hook(
            mask_hook(own, [(m[start:stop], b[start:stop]) for m, b in ref["masks"]]))
        opt = make_optimizer(model, _parallel_args(per_device_train_batch_size=stop - start,
                                                   model_parallel_size=model_parallel), 8, mesh.data_width)
        bucket_ms.clear()
        heads.clear()
        patched = (losses.hungarian_batch, pixel_decoder.deform_sample_levels,
                   transformer_decoder.masked_cross_attention)
        losses.hungarian_batch = _recording_matcher(assignments, ref["assignments"], slice(start, stop))
        pixel_decoder.deform_sample_levels = heads_of(patched[1], 2)
        transformer_decoder.masked_cross_attention = heads_of(patched[2], 1)
        try:
            dist.barrier()
            rec = _step_record(model, net, opt, batch, torch.Generator(device=mesh.device).manual_seed(seed), pp,
                               kernel_fed_leaves(cfg), mesh, lambda: (len(sync_ms), sum(sync_ms)))
        finally:
            losses.hungarian_batch, pixel_decoder.deform_sample_levels, \
                transformer_decoder.masked_cross_attention = patched
        mask_flips = sum((((ga < 0) & ~gb[..., None]) != ((ca < 0) & ~cb[..., None])).sum().item()
                         for (ga, gb), (ca, cb) in zip([(m[start:stop], b[start:stop]) for m, b in ref["masks"]][:-1],
                                                       own[:-1]))
        assign_flips = sum((a != g[:, start:stop]).sum().item() for a, g in zip(assignments, ref["assignments"]))
        flat = torch.cat([v.float().flatten() for v in full_state_dict(model).values()])
        theirs = flat.clone()
        dist.broadcast(theirs, src=0)
        rec.update(blocks=blocks, heads=sorted(heads), mask_flips=mask_flips, assign_flips=assign_flips,
                   rows=(start, stop), differ_from_rank0=int((theirs != flat).sum().item()),
                   bucket_ms=(len(bucket_ms), sum(bucket_ms)))
        results[key] = rec
        del net, model, opt
        torch.cuda.empty_cache()

    # (d) eval: a Trainer over the eval examples at a global batch of 2 (1 per
    # rank), by the device-stats route and by the host mask route
    # (RGBDSEG_EVAL_DEVICE_STATS=0 in this process's environment).
    lines = []

    class Keep(logging.Handler):
        def emit(self, record):
            lines.append(record.getMessage())

    handler = Keep(logging.INFO)
    trainer_log = logging.getLogger("rgbdseg_torch.train.trainer")
    trainer_log.addHandler(handler)
    trainer_log.setLevel(logging.INFO)
    trainer = Trainer(cfg, _parallel_args(num_devices=2, per_device_eval_batch_size=EVAL_B // 2, seed=seed,
                                          output_dir=str(work / f"eval{rank}")),
                      None, BatchSet(ref["eval"]), {i: f"class{i}" for i in range(cfg.num_labels)}, device=device)
    previous = os.environ.get("RGBDSEG_EVAL_DEVICE_STATS")
    try:
        for route, switch in (("device stats", "1"), ("host masks", "0")):
            os.environ["RGBDSEG_EVAL_DEVICE_STATS"] = switch
            lines.clear()
            sync_ms.clear()
            sync_bytes.clear()
            K.reset_launches()
            metrics, ms = _timed(trainer.evaluate)
            results.setdefault("eval", {})[route] = {
                "metrics": metrics, "ms": ms, "launches": dict(K.LAUNCHES),
                "lines": [ln for ln in lines if "device-stats path" in ln],
                "sync_ms": (len(sync_ms), sum(sync_ms)), "sync_bytes": sum(sync_bytes)}
    finally:
        if previous is None:
            os.environ.pop("RGBDSEG_EVAL_DEVICE_STATS", None)
        else:
            os.environ["RGBDSEG_EVAL_DEVICE_STATS"] = previous
        trainer_log.removeHandler(handler)
    dist.all_reduce = original_all_reduce
    AdamW._average_replicated = original_average
    results["tp"]["replicated"] = replicated
    torch.save(results, work / f"child{rank}.pt")
    dist.destroy_process_group()
    return 0


def run_parallel(seed: int, rng, step0, batch, eval_batches_, repo: Path, device: str = "cuda",
                 backend: str = "nccl", card: str = "") -> dict:
    """Phase 18: data and tensor parallelism on the card. (a) NCCL at world size
    1 (`run_parallel_nccl`); then the one-process reference at the global batch
    and two child processes sharing the card over Gloo (`parallel_child`): (b)
    dp=2 and (c) dp=1 x mp=2 against the reference, to phase 7's bounds, on the
    reference's attention masks and assignments (the flips of each rank's own
    counted and printed), both ranks' parameters equal bit for bit, (c) with K1
    and K3 forward and backward at 4 heads; (d) `Trainer.evaluate` in the two
    processes against one, by both routes (device stats; host masks under
    RGBDSEG_EVAL_DEVICE_STATS=0): the metric keys, every mAP within
    PARALLEL_MAP_TOL, the loss within PARALLEL_EVAL_RTOL, the device-stats path
    logged on its route alone, 6 K1 + 9 K3 launches per batch on each, the two
    routes' mAP keys equal on each rank; then the four kernels at 4 heads
    against their plain versions, timed (phases 3 and 5 at TP_HEADS). Returns the launches of the steps and evals run here, the
    children's summed. `device` and `backend` are the card's and NCCL; the
    children share the card (`cuda:0`, LOCAL_RANK 0) over Gloo. `card` (its
    name and power limit) closes every line of readings."""
    import os
    import shutil
    import subprocess

    import torch

    from rgbdseg_torch.config import ModelConfig, PreprocessConfig
    from rgbdseg_torch.ops import kernels as K
    from rgbdseg_torch.train.trainer import Trainer

    global NH
    pp = PreprocessConfig(height=480, width=640)
    cfg = ModelConfig(num_labels=40, version="0.4.0")
    launches = run_parallel_nccl(seed, step0, batch, pp, cfg, device, backend, card)
    work = repo / "build" / "chip_smoke" / "parallel"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    ref, t_ref = _timed(lambda: parallel_reference(seed, step0, batch, pp, cfg, device))
    child_device = "cuda:0" if torch.device(device).type == "cuda" else device
    torch.save({"batch": [t.cpu() for t in batch], "masks": ref["masks"], "assignments": ref["assignments"],
                "eval": eval_batches_, "cfg": cfg.to_json(), "device": child_device}, work / "reference.pt")

    port = _free_port()
    procs, logs = [], []
    t0 = time.perf_counter()
    for rank in range(2):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE="2", LOCAL_RANK="0", MASTER_ADDR="localhost",
                   MASTER_PORT=str(port))
        logs.append(open(work / f"child{rank}.log", "w"))
        procs.append(subprocess.Popen([sys.executable, str(repo / "chip_smoke.py"), "--parallel-child", str(work),
                                       "--seed", str(seed)], env=env, stdout=logs[-1], stderr=subprocess.STDOUT))

    # The reference eval runs while the children start.
    trainer = Trainer(cfg, _parallel_args(per_device_eval_batch_size=EVAL_B, seed=seed,
                                          output_dir=str(work / "eval")),
                      None, BatchSet(eval_batches_), {i: f"class{i}" for i in range(cfg.num_labels)}, device=device)
    K.reset_launches()
    ref_metrics, t_eval = _timed(trainer.evaluate)
    for k, v in K.LAUNCHES.items():
        launches[k] += v
    del trainer
    try:
        for p in procs:
            p.wait(timeout=max(1.0, PARALLEL_TIMEOUT_S - (time.perf_counter() - t0)))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    t_children = time.perf_counter() - t0
    failed = [r for r, p in enumerate(procs) if p.returncode != 0]
    if failed:
        tails = "\n".join(f"--- child {r} (exit {procs[r].returncode}):\n"
                          + (work / f"child{r}.log").read_text()[-3000:] for r in failed)
        raise AssertionError(f"parallel: child process(es) {failed} failed\n{tails}")
    kids = [torch.load(work / f"child{r}.pt", weights_only=False) for r in range(2)]
    log(f"parallel: the one-process reference step {t_ref:.1f} ms, eval {t_eval:.1f} ms; two children "
        f"{t_children:.1f} s from spawn to exit (imports, CUDA context, 3 full-width model builds each) [{card}]")

    for label, key in (("(b) dp=2, batch 1 per rank", "dp"), ("(c) dp=1 x mp=2, batch 2 per rank", "tp")):
        for kid in kids:
            r = kid[key]
            leaf = {n: ((r["grads"][n] - g).abs().max() / g.abs().max()).nan_to_num(float("inf")).item()
                    for n, g in ref["grads"].items()}
            worst = max(leaf, key=leaf.get)
            got = (abs(r["loss"] - ref["loss"]) / abs(ref["loss"]), abs(r["norm"] - ref["norm"]) / abs(ref["norm"]),
                   leaf[worst])
            bn = max((r["bn"][k] - v).abs().max().item() for k, v in ref["bn"].items())
            log(f"parallel {label}, rank {kid['rank']} (rows {r['rows']}): loss {r['loss']:.7f} / {ref['loss']:.7f} "
                f"(rel {got[0]:.2e}), grad norm {r['norm']:.6f} / {ref['norm']:.6f} (rel {got[1]:.2e}), worst "
                f"kernel-fed leaf {got[2]:.2e} ({worst}), BatchNorm statistics max |diff| {bn:.2e}; own attention-"
                f"mask entries that differ from the shared ones {r['mask_flips']}, assignments {r['assign_flips']}; "
                f"parameters differing from rank 0: {r['differ_from_rank0']}; step ms micro {r['ms'][0]:.2f} + "
                f"apply {r['ms'][1]:.2f}; blocking collectives {r['collectives'][0]} calls {r['collectives'][1]:.2f} ms, "
                f"DDP buckets {r['bucket_ms'][0]} ({r['bucket_ms'][1]:.2f} ms issue to completion, overlapping the "
                f"backward); launches {r['launches']}; kernel heads {r['heads']} [{card}]")
            if not all(x <= tol for x, tol in zip(got, STEP0_SAME_RTOL)) or not bn <= PARALLEL_BN_TOL:
                raise AssertionError(f"parallel {label} rank {kid['rank']}: {got} > {STEP0_SAME_RTOL} or BatchNorm "
                                     f"{bn} > {PARALLEL_BN_TOL}")
            if r["differ_from_rank0"]:
                raise AssertionError(f"parallel {label}: rank {kid['rank']}'s parameters differ from rank 0's")
            if r["launches"] != TRAIN_LAUNCHES:
                raise AssertionError(f"parallel {label}: launches {r['launches']}, expected {TRAIN_LAUNCHES}")
            want_heads = NH if key == "dp" else TP_HEADS
            if {h for _, h in r["heads"]} != {want_heads}:
                raise AssertionError(f"parallel {label}: the kernels ran at heads {r['heads']}, not {want_heads}")
            for k, v in r["launches"].items():
                launches[k] += v
        if key == "tp":
            log(f"parallel (c): {len(kids[0]['tp']['blocks'])} blocks sharded over the model group: "
                + ", ".join(kids[0]["tp"]["blocks"]))
            log(f"parallel (c): the replicated gradients before the optimizer's model-group mean, (elements that "
                f"differ from rank 0's, elements) per step: rank 1 {kids[1]['tp']['replicated']}; agree bit for bit: "
                f"{all(d == 0 for d, _ in kids[1]['tp']['replicated'])} [{card}]")

    keys = lambda m: {k for k in m if not k.endswith(("runtime", "samples_per_second"))}  # noqa: E731
    expected = {k: v * len(eval_batches_) for k, v in EVAL_LAUNCHES.items()}
    for kid in kids:
        for route, e in kid["eval"].items():
            got = e["metrics"]
            if keys(got) != keys(ref_metrics):
                raise AssertionError(f"parallel (d) {route}: metric keys differ: "
                                     f"{sorted(keys(got) ^ keys(ref_metrics))}")
            loss_rel = abs(got["eval_loss"] - ref_metrics["eval_loss"]) / abs(ref_metrics["eval_loss"])
            maps = {k: abs(got[k] - ref_metrics[k]) for k in keys(got) if k != "eval_loss"}
            log(f"parallel (d) eval, {route}, rank {kid['rank']}: {len(keys(got))} metric keys, eval_loss "
                f"{got['eval_loss']:.7f} / {ref_metrics['eval_loss']:.7f} (rel {loss_rel:.2e}), mAP keys equal bit "
                f"for bit {sum(d == 0 for d in maps.values())} of {len(maps)} (max |diff| {max(maps.values()):.2e}), "
                f"eval_map {got['eval_map']:.6f}; {e['ms']:.1f} ms ({ref_metrics['eval_runtime'] * 1e3:.1f} in one "
                f"process, {t_eval:.1f} with its set-up); blocking all-reduces {e['sync_ms'][0]} calls "
                f"{e['sync_ms'][1]:.2f} ms, {e['sync_bytes']} bytes; launches {e['launches']}; {e['lines'][:1]} "
                f"[{card}]")
            if not loss_rel <= PARALLEL_EVAL_RTOL or max(maps.values()) > PARALLEL_MAP_TOL:
                raise AssertionError(f"parallel (d) {route} rank {kid['rank']}: loss {loss_rel}, mAP "
                                     f"{max(maps.values())}")
            if bool(e["lines"]) != (route == "device stats"):
                raise AssertionError(f"parallel (d) {route} rank {kid['rank']}: device-stats path logged "
                                     f"{e['lines'][:1]}")
            if e["launches"] != expected:
                raise AssertionError(f"parallel (d) {route} rank {kid['rank']}: launches {e['launches']}, "
                                     f"expected {expected}")
            for k, v in e["launches"].items():
                launches[k] += v
        # one forward's logits on both routes: their metric inputs, and so their mAP keys, are the same
        dev, host = ({k: m[k] for k in keys(m) if k != "eval_loss"}
                     for m in (kid["eval"][r]["metrics"] for r in ("device stats", "host masks")))
        if dev != host:
            raise AssertionError(f"parallel (d) rank {kid['rank']}: the two routes' mAP keys differ: "
                                 f"{ {k: (dev[k], host.get(k)) for k in dev if dev[k] != host.get(k)} }")
        log(f"parallel (d) rank {kid['rank']}: host mask route {kid['eval']['host masks']['ms']:.1f} ms against "
            f"device stats {kid['eval']['device stats']['ms']:.1f} ms, all-reduced "
            f"{kid['eval']['host masks']['sync_bytes']} against {kid['eval']['device stats']['sync_bytes']} bytes "
            f"[{card}]")

    run_qa_viewers(rng, repo / "build" / "chip_smoke" / "qa", device, card)
    log(f"parallel (c): the four kernels at {TP_HEADS} heads (one rank's share under model_parallel_size 2) "
        f"[{card}]:")
    NH = TP_HEADS
    try:
        check_kernels(rng, torch.device(device))
        check_backward_kernels(rng, torch.device(device))
    finally:
        NH = MODEL_NH
    return launches


def run_qa_viewers(rng, out_dir: Path, device: str = "cuda", card: str = "") -> None:
    """Phase 18e: the QA viewers on the card (`tools/qa_viewers.py`):
    `csf_viewer` over 8 480x640 three-channel frames and the histogram and
    region viewers of a 480x640 depth plane, against the same viewers on the
    CPU. The DSAM intermediates must be equal bit for bit; CSF's similarities
    within 1e-6, and its discrete outputs (each round's source per pixel) are
    counted where they differ: with none, every CSF intermediate must be equal
    bit for bit. The PNGs are read back at their expected sizes."""
    import shutil

    from rgbdseg_torch.data.image_io import read_png
    from rgbdseg_torch.tools import qa_viewers as Q

    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    _, depth, _ = synthetic_frame(rng)
    frames = np.stack([np.clip(depth_rgb(depth).astype(np.int16) + rng.randint(-24, 25, (480, 640, 3)), 0, 255)
                       for _ in range(8)]).astype(np.uint8)
    depth = depth.astype(np.float32)
    views = {}
    for name, fn in (("csf", lambda dev, save: Q.csf_viewer(frames, save=save, device=dev)),
                     ("histogram", lambda dev, save: Q.dsam_histogram_viewer(depth, save=save, device=dev)),
                     ("regions", lambda dev, save: Q.dsam_region_viewer(depth, save=save, device=dev))):
        gpu, t_gpu = _timed(lambda: fn(device, str(out_dir / f"{name}.png")))
        t = time.perf_counter()
        cpu = fn("cpu", None)
        views[name] = (gpu, cpu, t_gpu, (time.perf_counter() - t) * 1e3)
    gpu, cpu, _, _ = views["csf"]
    flips = int((gpu["best"] != cpu["best"]).sum())
    finite = np.isfinite(cpu["sim"])  # the diagonal is -inf on both
    diff = np.subtract(gpu["sim"], cpu["sim"], out=np.zeros_like(cpu["sim"]), where=finite)
    sim_err = float(np.abs(diff).max()) if np.array_equal(np.isfinite(gpu["sim"]), finite) else float("inf")
    csf_equal = {k: bool(np.array_equal(gpu[k], cpu[k])) for k in ("sim", "best", "round_images", "counts", "scores",
                                                                     "weights", "fused", "image")}
    dsam_equal = {f"{name}.{k}": bool(np.array_equal(views[name][0][k], views[name][1][k]))
                  for name in ("histogram", "regions") for k in views[name][1]}
    sizes = {name: read_png(str(out_dir / f"{name}.png")).shape for name in views}
    want = {"csf": (8 * (480 + Q.GAP) - Q.GAP, 9 * (640 + Q.GAP) - Q.GAP, 3), "histogram": (200, 512, 3),
            "regions": (480, (views["regions"][0]["masks"].shape[0] + 1) * (640 + Q.GAP) - Q.GAP, 3)}
    log(f"qa viewers (e): card vs CPU, CSF bit for bit {csf_equal}, similarity max |diff| {sim_err:.2e}, "
        f"{flips} of {gpu['best'].size} source pixels differ; DSAM all equal {all(dsam_equal.values())} "
        f"({len(dsam_equal)} arrays), {int(views['histogram'][0]['valid'].sum())} modes; PNG sizes {sizes}; ms on the "
        f"card with the PNG (CPU without): " + ", ".join(f"{n} {v[2]:.1f} ({v[3]:.1f})" for n, v in views.items())
        + f" [{card}]")
    if sizes != want:
        raise AssertionError(f"qa viewers: PNG sizes {sizes}, expected {want}")
    if not all(dsam_equal.values()) or not sim_err <= 1e-6 or flips > 1e-4 * gpu["best"].size or (
            not flips and not all(csf_equal.values())):
        raise AssertionError(f"qa viewers: card and CPU differ: {csf_equal}, {dsam_equal}, sim {sim_err}, "
                             f"{flips} source flips")


# The tools phase (20): the host tools of rgbdseg_torch/tools/ around the data
# layer, on a RealSense-sized depth stream and a COCO set they turn into a
# training set.
CURATION_FRAMES = 20  # z16 frames timed through do_depth_image_process
TOOLS_IMAGES, TOOLS_TRAIN = 8, 4  # the COCO set's images and its train split
CURATION_LIMIT_MS = 33.0  # one frame of a 30 fps camera (PERF.md §2)


def z16_frame(rng, h: int = 720, w: int = 1280) -> np.ndarray:
    """A RealSense D435 depth frame: a 300-5000 mm ramp, noise, ~5% zeros."""
    depth = np.linspace(300, 5000, w)[None, :] + rng.normal(0, 25, (h, w))
    depth[rng.rand(h, w) < 0.05] = 0
    return np.clip(depth, 0, 65535).astype(np.uint16)


def tools_coco(rng, root: Path, n: int = TOOLS_IMAGES, h: int = 480, w: int = 640) -> Path:
    """A seeded COCO set under `root`: n RGB frames and their 8-bit depth, each
    with 4-12 instances of 3 categories: convex and concave polygons, one
    touching the border per image, and RLE donuts."""
    from rgbdseg_torch.data.image_io import write_png
    from rgbdseg_torch.inference import rle

    (root / "images").mkdir(parents=True)
    (root / "depth").mkdir()
    images, annotations = [], []
    for i in range(n):
        rgb, depth, _ = synthetic_frame(rng, h, w)
        write_png(str(root / "images" / f"{i}.png"), rgb)
        write_png(str(root / "depth" / f"{i}.png"), depth)
        images.append({"id": i, "file_name": f"{i}.png", "height": h, "width": w})
        for k in range(rng.randint(4, 13)):
            cx, cy, r = rng.uniform(0.1 * w, 0.9 * w), rng.uniform(0.1 * h, 0.9 * h), rng.uniform(20, 90)
            if k == 0:  # over the border
                cx, cy = rng.choice([-0.2 * r, w + 0.2 * r]), rng.uniform(0, h)
            if k % 4 == 3:
                yy, xx = np.mgrid[0:h, 0:w]
                dist = np.hypot(yy - cy, xx - cx)
                seg = rle.encode(((dist <= r) & (dist > r / 2)).astype(np.uint8))
            else:
                n_v = rng.randint(5, 24)
                t = np.sort(rng.uniform(0, 2 * np.pi, n_v))
                rad = r * (1 + (0.6 if k % 2 else 0.0) * rng.uniform(-1, 1, n_v))  # concave when odd
                seg = [np.stack([cx + rad * np.cos(t), cy + rad * np.sin(t)], 1).reshape(-1).tolist()]
            annotations.append({"id": len(annotations) + 1, "image_id": i, "category_id": (4, 2, 9)[k % 3],
                                "segmentation": seg, "iscrowd": 0})
    coco = {"images": images, "annotations": annotations,
            "categories": [{"id": 4, "name": "cup"}, {"id": 2, "name": "box"}, {"id": 9, "name": "can"}]}
    path = root / "coco.json"
    path.write_text(json.dumps(coco))
    return path


def run_curation(rng, out_dir: Path, device: str = "cuda", card: str = "") -> None:
    """Phase 20a: `do_depth_image_process` of a 720x1280 z16 frame on the card
    and on the CPU (all 8 outputs equal bit for bit), the ms per frame over
    CURATION_FRAMES frames on the host clock with each operation's share, and
    `save_frame`'s PNGs read back equal."""
    import torch

    from rgbdseg_torch.data.image_io import load_unchanged
    from rgbdseg_torch.tools.realsense import depth_enhance as E
    from rgbdseg_torch.tools.realsense import display

    sync = torch.cuda.synchronize if device != "cpu" else (lambda: None)
    depth = z16_frame(rng)
    got = display.do_depth_image_process(depth, device)
    want = display.do_depth_image_process(depth, "cpu")
    equal = {k: bool(torch.equal(got[k].cpu(), want[k])) for k in want}
    if len(equal) != 8 or not all(equal.values()):
        raise AssertionError(f"curation: card and CPU differ: {equal}")
    frame_ms = []
    for d in [z16_frame(rng) for _ in range(CURATION_FRAMES)]:
        sync()
        t = time.perf_counter()
        display.do_depth_image_process(d, device)
        sync()
        frame_ms.append((time.perf_counter() - t) * 1e3)
    mean_ms = sum(frame_ms) / len(frame_ms)
    sync()
    t = time.perf_counter()
    for _ in range(CURATION_FRAMES):
        display.do_depth_image_process(depth, device)
    sync()
    pipelined_ms = (time.perf_counter() - t) * 1e3 / CURATION_FRAMES
    d32 = E.u16_to_device(depth, device)
    gray = E.convert_scale_abs(d32, alpha=0.03)
    ops = {"upload": lambda: E.u16_to_device(depth, device),
           "convertScaleAbs": lambda: E.convert_scale_abs(d32, alpha=0.03),
           "jet": lambda: E.apply_colormap(gray, E.COLORMAP_JET),
           "bone": lambda: E.apply_colormap(gray, E.COLORMAP_BONE),
           **{name: (lambda fn=fn: fn(gray)) for name, fn in E.ENHANCEMENTS.items()}}
    op_ms = {}
    for name, fn in ops.items():
        fn()
        sync()
        t = time.perf_counter()
        for _ in range(CURATION_FRAMES):
            fn()
        sync()
        op_ms[name] = (time.perf_counter() - t) * 1e3 / CURATION_FRAMES
    t = time.perf_counter()
    display.do_depth_image_process(depth, "cpu")
    cpu_ms = (time.perf_counter() - t) * 1e3
    frame = {"color": rng.randint(0, 256, (720, 1280, 3)).astype(np.uint8), "depth_raw": depth,
             **{k: v.cpu().numpy() for k, v in got.items()}}
    display.save_frame(str(out_dir), 0, frame)
    back = {k: np.array_equal(load_unchanged(str(out_dir / k / "0.png")), v) for k, v in frame.items()}
    if not all(back.values()):
        raise AssertionError(f"curation: saved PNGs differ from the frame: {back}")
    shares = ", ".join(f"{k} {v:.3f} ms ({100 * v / mean_ms:.1f}%)" for k, v in op_ms.items())
    log(f"tools (a) curation: 720x1280 z16 frame, 8 outputs card = CPU bit for bit; {mean_ms:.3f} ms per frame "
        f"over {len(frame_ms)} frames (host clock, each synchronised, upload included; min {min(frame_ms):.3f}, "
        f"median {sorted(frame_ms)[len(frame_ms) // 2]:.3f}, max {max(frame_ms):.3f}; limit {CURATION_LIMIT_MS} "
        f"ms); {pipelined_ms:.3f} ms per frame with one synchronise after {CURATION_FRAMES}; per op, {CURATION_FRAMES} calls each on one frame, and its share of the mean frame: {shares}; CPU "
        f"{cpu_ms:.1f} ms per frame; {len(back)} PNGs read back equal [{card}]")


def run_tools(seed: int, rng, out_dir: Path, device: str = "cuda", card: str = "", model_config=None,
              size: tuple = (480, 640)) -> dict:
    """Phase 20, the tools: (a) depth curation; (b) a COCO set of TOOLS_IMAGES
    frames through `dataset_constructor`, `AnnotationConverter.convert` and
    `convert_to_coco_json`; (c) `finetune_torch.main` on the built set (0.4.0,
    f32, 1 epoch of 2 steps at batch 2; the 16-bit masks through
    `SegmentationDataset`), 6 K1 + 9 K3 launches per micro-step forward and
    backward; (d) `plot_logs` of its trainer_state.json, `mask_check.label_check`
    of its train meta (the card's overlays equal to the CPU's) and
    `predict_torch.py --compare` of its prediction and GT JSONs. Returns the
    kernels' launches of (c) and (d)."""
    import shutil

    import torch

    import finetune_torch
    import predict_torch
    from rgbdseg_torch.data.image_io import load_unchanged, png_header, read_png
    from rgbdseg_torch.ops import kernels as K
    from rgbdseg_torch.tools import annotation_converter, dataset_builder, labelme_coco, mask_check, plot_logs
    from rgbdseg_torch.tools.dataset_builder import polygon_to_mask
    from rgbdseg_torch.train import trainer as T

    shutil.rmtree(out_dir, ignore_errors=True)
    (out_dir / "frames").mkdir(parents=True)
    run_curation(rng, out_dir / "frames", device, card)

    # (b) the dataset
    src = out_dir / "src"
    coco_path = tools_coco(rng, src, h=size[0], w=size[1])
    coco = json.loads(coco_path.read_text())
    n_ann, n_rle = len(coco["annotations"]), sum(isinstance(a["segmentation"], dict) for a in coco["annotations"])
    built = out_dir / "set"
    fx, t_build = _timed(lambda: dataset_builder.dataset_constructor(
        str(coco_path), str(src / "images"), str(built), train_ratio=TOOLS_TRAIN / TOOLS_IMAGES, seed=seed))
    records = json.loads(Path(fx["train"]).read_text()) + json.loads(Path(fx["valid"]).read_text())
    depths = [png_header(r["annotation"])[2] for r in records]
    if depths != [16] * TOOLS_IMAGES:
        raise AssertionError(f"built masks' bit depths {depths}; the tools write 16-bit masks")
    conv = annotation_converter.AnnotationConverter(str(out_dir / "converted"))
    converted, t_convert = _timed(lambda: conv.convert("coco", str(coco_path)))
    back, t_back = _timed(lambda: conv.convert_to_coco_json(records, str(out_dir / "back.json")))
    # the hole-free instances' polygons filled again, against their instances'
    # masks (the instance most of the filled pixels belong to)
    refill, n_poly = 0, 0
    for a in back["annotations"]:
        if isinstance(a["segmentation"], list):
            inst = load_unchanged(records[a["image_id"]]["annotation"])[..., 1]
            filled = polygon_to_mask(a["segmentation"], *inst.shape).astype(bool)
            iid = int(np.bincount(inst[filled & (inst > 0)]).argmax())
            refill += int(((inst == iid) != filled).sum())
            n_poly += 1
    log(f"tools (b) dataset: {TOOLS_IMAGES} {size[0]}x{size[1]} images, {n_ann} annotations ({n_rle} RLE donuts); "
        f"dataset_constructor {t_build / TOOLS_IMAGES:.1f} ms per image, AnnotationConverter.convert "
        f"{t_convert / len(converted):.1f} ms, convert_to_coco_json {t_back / len(records):.1f} ms (host); "
        f"{len(back['annotations'])} annotations back, {n_poly} as polygons: {refill} pixels differ when filled again "
        f"(a reading), {conv.instance_counter} instances converted")

    # (c) train on it: [rgb, depth] records, the layout 0.4.0 reads
    meta = {}
    for split in ("train", "valid"):
        recs = json.loads(Path(fx[split]).read_text())
        meta[split] = labelme_coco.build_multimodal_meta(recs, [str(src / "depth")], str(built / f"{split}_rgbd.json"))
    run = out_dir / "run"
    config = {
        "root_path": str(built), "train_json_path": "train_rgbd.json", "valid_json_path": "valid_rgbd.json",
        "label2id_path": "label2id.json", "image_height": size[0], "image_width": size[1], "version": "0.4.0",
        "output_dir": str(run), "num_train_epochs": 1, "per_device_train_batch_size": 2,
        "per_device_eval_batch_size": 2, "learning_rate": 1e-4, "seed": seed, "save_strategy": "no",
        "do_eval": True, "max_instances": 16, "prediction_json_path": str(run / "pred.json"),
        "gt_json_path": str(run / "gt.json"), "comparison_output_dir": str(run / "comparison"),
    }
    if model_config is not None:
        (out_dir / "model.json").write_text(model_config.to_json())
        config["model_config_json"] = str(out_dir / "model.json")
    (out_dir / "finetune.json").write_text(json.dumps(config))
    micro, orig_micro = [], T.micro_step

    def counted_micro(*a, **k):
        before = dict(K.LAUNCHES)
        out = orig_micro(*a, **k)
        micro.append(({n: K.LAUNCHES[n] - before[n] for n in K.LAUNCHES}, float(out[0])))
        return out

    T.micro_step = counted_micro
    try:
        K.reset_launches()
        _, t_ft = _timed(lambda: finetune_torch.main([str(out_dir / "finetune.json")], device=device))
    finally:
        T.micro_step = orig_micro
    launches = dict(K.LAUNCHES)
    expect = TRAIN_LAUNCHES if device != "cpu" else {k: 0 for k in TRAIN_LAUNCHES}
    losses = [x for _, x in micro]
    if len(micro) != TOOLS_TRAIN // 2 or any(d != expect for d, _ in micro) or not np.isfinite(losses).all():
        raise AssertionError(f"tools (c): micro-steps {micro}; expected {TOOLS_TRAIN // 2} x {expect}, finite loss")
    log(f"tools (c) train: finetune_torch.main on the built set ({len(meta['train'])} train, {len(meta['valid'])} "
        f"valid [rgb, depth] records, 16-bit masks), {t_ft / 1e3:.1f} s; micro-step losses "
        f"{[round(x, 4) for x in losses]}, each launching {micro[0][0]}; all launches {launches}")

    # (d) plots, mask checks and comparison grids
    written = plot_logs.main([str(run / "trainer_state.json"), "--output_dir", str(out_dir / "plots")])
    shapes = [read_png(p).shape for p in written]
    if [os.path.basename(p) for p in written][:1] != ["training_metrics.png"] or \
            shapes[0] != (2 * plot_logs.PANEL_H, 3 * plot_logs.PANEL_W, 3):
        raise AssertionError(f"plot_logs wrote {written} {shapes}")
    checked, t_check = _timed(lambda: mask_check.label_check(
        str(built / "train.json"), "", str(out_dir / "checks"), device=device))
    overlays = [(mask_check.visualize_masks(r["image"][0], r["annotation"], device=device),
                 mask_check.visualize_masks(r["image"][0], r["annotation"], device="cpu")) for r in meta["train"]]
    same = [bool(np.array_equal(a, b)) for a, b in overlays]
    reread = [read_png(str(out_dir / "checks" / f"check_{i}.png")).shape for i in range(checked)]
    if checked != TOOLS_TRAIN or not all(same) or reread != [(size[0], 3 * size[1], 3)] * checked:
        raise AssertionError(f"mask_check: {checked} checked, card = CPU {same}, PNGs {reread}")
    grids = out_dir / "grids"
    predict_torch.main(["--compare", "--gt_json", str(run / "gt.json"), "--model_json", f"finetune={run / 'pred.json'}",
                        "--output_dir", str(grids)], device=device)
    names = sorted(os.listdir(grids))
    n_gt = len({r["image_id"] for r in json.loads((run / "gt.json").read_text())})
    grid_shapes = {read_png(str(grids / n)).shape for n in names}
    if len(names) != n_gt or not names:
        raise AssertionError(f"--compare wrote {names} for {n_gt} GT images")
    log(f"tools (d) figures: plot_logs {[os.path.basename(p) for p in written]} {shapes}; label_check {checked} "
        f"overlays in {t_check:.1f} ms, card = CPU {same}; --compare wrote {len(names)} grids {grid_shapes}")
    return launches


# The bench phase (21): `bench_torch.py`, the port's counterpart of bench.py.
BENCH_ITERS, BENCH_DISK_N = 3, 8  # timed calls per section; the disk-fed bench's examples
ALL_KEYS = {"metric", "value", "unit", "vs_baseline", "tflops_per_sec", "mfu", "device_kind", "wall_ms_per_image",
            "chunk_ms_per_image", "device_ms_per_image", "train_images_per_sec", "train_vs_baseline", "train_mfu",
            "train_device_ms_per_step", "eval_images_per_sec", "eval_vs_baseline", "eval_metric_compute_s"}


@contextlib.contextmanager
def forwards_by_mode():
    """{True: train-mode forwards, False: eval-mode ones} of Mask2FormerRGBD while the block runs."""
    from rgbdseg_torch.models.mask2former import Mask2FormerRGBD

    counts = {True: 0, False: 0}
    original = Mask2FormerRGBD.forward

    def forward(self, *a, **kw):
        counts[self.training] += 1
        return original(self, *a, **kw)

    Mask2FormerRGBD.forward = forward
    try:
        yield counts
    finally:
        Mask2FormerRGBD.forward = original


def _check_bench_result(label: str, r: dict, keys: set) -> None:
    """The keys of the mode; every number finite and positive (the rounded
    compute seconds may read 0); MFU in (0, 1]; device ms per call within
    1.05 x the wall ms."""
    if set(r) != keys:
        raise AssertionError(f"bench {label}: keys {sorted(r)}, expected {sorted(keys)}")
    for k, v in r.items():
        if isinstance(v, (str, bool)):
            continue
        for x in v if isinstance(v, list) else [v]:
            if not (np.isfinite(x) and (x > 0 or (k.endswith("compute_s") and x == 0))):
                raise AssertionError(f"bench {label}: {k} = {v}")
    for k in ("mfu", "train_mfu"):
        if k in r and not 0 < r[k] <= 1:
            raise AssertionError(f"bench {label}: {k} = {r[k]} outside (0, 1]")
    for dev, wall in (("device_ms_per_image", "wall_ms_per_image"), ("device_ms_per_step", "wall_ms_per_step")):
        if dev in r and not r[dev] <= 1.05 * r[wall]:
            raise AssertionError(f"bench {label}: {dev} {r[dev]} above 1.05 x {wall} {r[wall]}")


def run_bench(repo: Path, card: str) -> dict:
    """Phase 21: `bench_torch.bench_infer`, `bench_train` and `bench_eval` in
    this process at BENCH_ITERS calls, and `bench_pipeline` over BENCH_DISK_N
    synthetic 480x640 examples written under build/chip_smoke/bench_disk, at
    the default dtype (bfloat16): each result's keys and values checked, and
    every forward's kernels launched on their bfloat16 routes (6 K1 and 9 K3
    per forward, 6 K1-bwd and 9 K3-bwd per train-mode forward); then
    `python3 bench_torch.py` in a child process with BENCH_ITERS and
    BENCH_DISK_N set, whose one stdout line must be the merged JSON of `all`.
    Returns the kernels' launches of this process's benches."""
    import torch

    import bench_torch

    total = {}
    env = {"BENCH_DISK_N": str(BENCH_DISK_N), "BENCH_DISK_ROOT": str(repo / "build" / "chip_smoke" / "bench_disk")}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        for mode, keys in (
            ("infer", {"metric", "value", "unit", "vs_baseline", "tflops_per_sec", "mfu", "device_kind",
                       "wall_ms_per_image", "chunk_ms_per_image", "device_ms_per_image"}),
            ("train", {"metric", "value", "unit", "vs_baseline", "tflops_per_sec", "mfu", "device_kind",
                       "wall_ms_per_step", "device_ms_per_step"}),
            ("eval", {"metric", "value", "unit", "vs_baseline", "metric_compute_s"}),
            ("pipeline", {"metric", "value", "unit", "vs_baseline", "pipeline_cold_img_s", "pipeline_cached_img_s",
                          "upload_bound_img_s", "device_channels", "host_cores"}),
        ):
            with launches_by_dtype() as by_dtype, forwards_by_mode() as fwd:
                r, ms = _timed(lambda: getattr(bench_torch, f"bench_{mode}")(iters=BENCH_ITERS))
            _check_bench_result(mode, r, keys)
            n, t = fwd[False] + fwd[True], fwd[True]
            want = {("deformable", "bfloat16"): 6 * n, ("masked_attention", "bfloat16"): 9 * n}
            if t:
                want.update({("deformable_bwd", "bfloat16"): 6 * t, ("masked_attention_bwd", "bfloat16"): 9 * t})
            if by_dtype != want or not n or (mode in ("train", "pipeline")) != (t == n):
                raise AssertionError(f"bench {mode}: {n} forwards ({t} in train mode), launches {by_dtype}; "
                                     f"expected {want}")
            for (name, _), c in by_dtype.items():
                total[name] = total.get(name, 0) + c
            log(f"bench {mode}: {json.dumps(r)}; {n} forwards ({t} train steps), launches by operand dtype "
                f"{sorted(by_dtype.items())}; {ms / 1e3:.1f} s [{card}]")
            torch.cuda.empty_cache()
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v

    child, ms = _timed(lambda: subprocess.run(
        [sys.executable, str(repo / "bench_torch.py")], cwd=repo, capture_output=True, text=True, timeout=600,
        env={**os.environ, "BENCH_ITERS": str(BENCH_ITERS), "BENCH_DISK_N": str(BENCH_DISK_N)}))
    lines = child.stdout.strip().splitlines()
    if child.returncode != 0 or len(lines) != 1:
        raise AssertionError(f"bench_torch.py: exit {child.returncode}, stdout {child.stdout[-2000:]!r}, "
                             f"stderr {child.stderr[-3000:]!r}")
    merged = json.loads(lines[0])
    _check_bench_result("all", merged, ALL_KEYS)
    if merged["device_kind"] != torch.cuda.get_device_name(0):
        raise AssertionError(f"bench all: device_kind {merged['device_kind']}")
    log(f"bench all (python3 bench_torch.py, BENCH_ITERS={BENCH_ITERS}): {lines[0]}; {ms / 1e3:.1f} s [{card}]")
    return total


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true",
                    help="also profile one request, one train step and one bf16 and one float32 step: device busy "
                         "share and the top kernels")
    ap.add_argument("--determinism-probe", action="store_true",
                    help="instead: find where a train step could part from run to run (see determinism_probe)")
    ap.add_argument("--parallel-child", type=Path, default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.determinism_probe:  # cuBLAS reads it when CUDA starts
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

    repo = Path(__file__).resolve().parent
    if not (repo / "rgbdseg_torch" / "csrc").is_dir():
        print("chip_smoke.py: no rgbdseg_torch package beside this script; run it from a checkout",
              file=sys.stderr)
        return 1
    import torch

    sys.path.insert(0, str(repo))
    if args.parallel_child is not None:  # phase 18's child process; its parent checked the card
        return parallel_child(args.parallel_child, args.seed)
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device", file=sys.stderr)
        return 1
    from rgbdseg_torch.ops import kernels as K

    if args.determinism_probe:
        return determinism_probe(args.seed)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"device: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}; TF32 off")

    log(f"build: {K.build_all():.1f} s")
    for name, text in K.BUILD_LOG.items():
        for line in K.ptxas_report(text):
            log(f"build {name}: {line}")

    rng = np.random.RandomState(args.seed)
    point_rng = np.random.RandomState(args.seed + 1)  # the point-sampling checks' own stream
    dev = torch.device("cuda")
    rows = check_kernels(rng, dev, point_rng)
    rows.update(check_backward_kernels(rng, dev, point_rng))
    check_bf16_kernels(rng, dev)
    rows.update(check_edsam_extract(np.random.RandomState(args.seed + 2), dev))
    launches, pred = run_slice(args.seed, rng, args.profile)
    train_launches, step0, batch = run_train(args.seed, rng, args.profile)
    step0_gpu_vs_cpu(step0, batch)
    log(f"step determinism: phase took {_timed(lambda: check_step_determinism(args.seed, step0, batch))[1] / 1e3:.1f} s")
    for label, phase in (("builder", lambda: check_builder(rng, dev)),
                         ("frame requests", lambda: run_frame_requests(rng, pred))):
        log(f"{label}: phase took {_timed(phase)[1] / 1e3:.1f} s")
    eval_set, t_eval = _timed(lambda: run_eval(rng, pred))
    log(f"eval: phase took {t_eval / 1e3:.1f} s")
    _, t_surface = _timed(lambda: run_predict_surface(rng, pred, repo / "build" / "chip_smoke"))
    log(f"predict surface: phase took {t_surface / 1e3:.1f} s")
    (step0, micro, steady), t_full = _timed(lambda: run_train_full(args.seed, rng))
    log(f"train full: phase took {t_full / 1e3:.1f} s")
    _, t_bf16 = _timed(lambda: run_bf16_step(args.seed, step0, micro, steady, profile=args.profile))
    log(f"bf16 step: phase took {t_bf16 / 1e3:.1f} s")
    (run, set_root), t_ft = _timed(lambda: run_finetune(args.seed, repo / "build" / "chip_smoke" / "finetune"))
    log(f"finetune: phase took {t_ft / 1e3:.1f} s")
    _, t_entry = _timed(lambda: run_predict_entry(run, set_root))
    log(f"predict entry: phase took {t_entry / 1e3:.1f} s")
    _, t_versions = _timed(lambda: run_versions(args.seed, rng))
    log(f"versions: phase took {t_versions / 1e3:.1f} s")
    launches.update({k: train_launches[k] for k in ("deformable_bwd", "masked_attention_bwd", "point_sample",
                                                    "point_sample_bwd")})
    parallel_launches, t_parallel = _timed(lambda: run_parallel(args.seed, rng, step0, micro[0], eval_set, repo,
                                                                card=smi))
    for k, v in parallel_launches.items():
        launches[k] += v
    log(f"parallel: phase took {t_parallel / 1e3:.1f} s [{smi}]")
    tools_launches, t_tools = _timed(lambda: run_tools(args.seed, rng, repo / "build" / "chip_smoke" / "tools",
                                                        card=smi))
    for k, v in tools_launches.items():
        launches[k] += v
    log(f"tools: phase took {t_tools / 1e3:.1f} s")
    bench_launches, t_bench = _timed(lambda: run_bench(repo, smi))
    for k, v in bench_launches.items():
        launches[k] += v
    log(f"bench: phase took {t_bench / 1e3:.1f} s")

    meta = {
        "deform_sample_levels": ("rgbdseg_torch/csrc/deformable.cu", "rgbdseg_tpu/ops/kernels/deformable.py:337", "deformable"),
        "masked_cross_attention": ("rgbdseg_torch/csrc/masked_attention.cu",
                                   "rgbdseg_tpu/ops/kernels/masked_attention.py:148", "masked_attention"),
        "deform_sample_levels_bwd": ("rgbdseg_torch/csrc/deformable_bwd.cu",
                                     "rgbdseg_tpu/ops/kernels/deformable.py:349", "deformable_bwd"),
        "masked_cross_attention_bwd": ("rgbdseg_torch/csrc/masked_attention_bwd.cu",
                                       "rgbdseg_tpu/ops/kernels/masked_attention.py:163", "masked_attention_bwd"),
        # no Pallas kernel: the JAX criterion's XLA point sampling and its custom VJP
        "point_sample": ("rgbdseg_torch/csrc/point_sample.cu", "rgbdseg_tpu/ops/losses.py:72", "point_sample"),
        "point_sample_bwd": ("rgbdseg_torch/csrc/point_sample.cu", "rgbdseg_tpu/ops/losses.py:102",
                             "point_sample_bwd"),
        # no Pallas kernel: E-DSAM's conv, BatchNorm, ReLU and pool, which the JAX package leaves to XLA
        "edsam_extract": ("rgbdseg_torch/csrc/edsam_extract.cu", "rgbdseg_tpu/models/fusion.py", "edsam_extract"),
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
