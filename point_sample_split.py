"""Split the point-sampling kernels' time on one card, and time their design variants.

    python3 point_sample_split.py [--seed N]

Builds copies of `rgbdseg_torch/csrc/point_sample.cu` into
`build/point_sample_split/`, each with named constants changed, and binds
them with ctypes beside the committed source's build:

- phases: the backward kernel with clock64 stamps around its three phases
  (compaction, lists, gather), read back per block; printed as cycles and
  microseconds at the SM clock `nvidia-smi` reports as its maximum;
- bands16, bands16x512, threads512: the backward at 16-row bands (twice the
  blocks), at 16-row bands of 512 threads, two blocks per SM (half the shared
  memory each), and at 32-row bands of 512 threads;
- runs1: the forward with one run of 1024 points per block.

At the criterion's geometry (`chip_smoke.point_sample_inputs`: 2 x 16 masks,
120x160 logits, 480x640 targets), each variant must give the committed
kernel's bits (the backward on bunched points too), and is timed as
`chip_smoke.time_ms` times it (a replayed CUDA graph), the committed kernel
before and after the variants. Needs one CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np

import chip_smoke as cs

ROOT = Path(__file__).resolve().parent
SOURCE = ROOT / "rgbdseg_torch" / "csrc" / "point_sample.cu"
OUT = ROOT / "build" / "point_sample_split"

PHASES = [
    ("namespace {\n", "namespace {\n__device__ long long g_phase[1 << 16];\n"),
    ("  int parity = 0;\n  zero_counts(s, cells);",
     "  int parity = 0;\n  const long long t0 = clock64();\n  zero_counts(s, cells);"),
    ("  __syncthreads();\n  if (n >= 0) {\n    build_lists(s, n, cells, parity);\n    gather(s, out, rows, w, 0, 4, true);\n",
     "  __syncthreads();\n  const long long t1 = clock64();\n  if (n >= 0) {\n    build_lists(s, n, cells, parity);\n"
     "    const long long t2 = clock64();\n    gather(s, out, rows, w, 0, 4, true);\n    __syncthreads();\n"
     "    if (threadIdx.x == 0) {\n      long long* p = g_phase + 4 * blockIdx.x;\n"
     "      p[0] = t1 - t0, p[1] = t2 - t1, p[2] = clock64() - t2, p[3] = n;\n    }\n"),
    ('extern "C" int rgbd_point_sample(',
     'extern "C" int phase_copy(void* dst, int n) { return (int)cudaMemcpyFromSymbol(dst, g_phase, n * 8); }\n'
     'extern "C" int rgbd_point_sample('),
]
BANDS16 = [("constexpr int kBandRows = 32;", "constexpr int kBandRows = 16;")]
THREADS512 = [("constexpr int kBwdThreads = 1024;", "constexpr int kBwdThreads = 512;")]
TWO_PER_SM = [("constexpr int kSmemBudget = 220 * 1024;", "constexpr int kSmemBudget = 110 * 1024;"),
              ("__launch_bounds__(kBwdThreads, 1) band_bwd_kernel", "__launch_bounds__(kBwdThreads, 2) band_bwd_kernel")]
VARIANTS = {
    "committed": [],
    "phases": PHASES,
    "bands16": BANDS16,
    "bands16x512": BANDS16 + THREADS512 + TWO_PER_SM,
    "threads512": THREADS512,
    "runs1": [("  const int runs = fwd_runs(bn, per_mask);", "  const int runs = 1;")],
}
FORWARD = ("committed", "runs1")


def build_all() -> dict:
    from rgbdseg_torch.ops.kernels import NVCC_FLAGS, _nvcc, ptxas_report

    OUT.mkdir(parents=True, exist_ok=True)
    text = SOURCE.read_text()
    jobs = {}
    for name, subs in VARIANTS.items():
        src = text
        for old, new in subs:
            if old not in src:
                raise RuntimeError(f"variant {name}: the source no longer has {old!r}")
            src = src.replace(old, new)
        (OUT / f"{name}.cu").write_text(src)
        so = OUT / f"lib{name}.so"
        jobs[name] = (subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-o", str(so), str(OUT / f"{name}.cu")],
                                       stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    libs = {}
    for name, (proc, so) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{log}")
        lib = ctypes.CDLL(str(so))
        for fn in (lib.rgbd_point_sample, lib.rgbd_point_sample_bwd):
            fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        libs[name] = lib
        cs.log(f"built {name}: " + "; ".join(line for line in ptxas_report(log) if "band_bwd" in line))
    return libs


def forward(lib, masks, coords):
    import torch

    b, n, h, w = masks.shape
    out = torch.empty(b, n, coords.shape[2], device=masks.device)
    err = lib.rgbd_point_sample(masks.data_ptr(), coords.data_ptr(), out.data_ptr(), b * n, coords.shape[2], h, w,
                                torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"forward launch failed: cudaError {err}")
    return out


def backward(lib, coords, g, h, w):
    import torch

    b, n, npts, _ = coords.shape
    out = torch.empty(b, n, h, w, device=coords.device)
    err = lib.rgbd_point_sample_bwd(coords.data_ptr(), g.data_ptr(), out.data_ptr(), b * n, npts, h, w,
                                    torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"backward launch failed: cudaError {err}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("point_sample_split.py: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    cs.log(f"device: {smi}")
    libs = build_all()
    dev = torch.device("cuda")
    rng = np.random.RandomState(args.seed)
    inputs = cs.point_sample_inputs(rng, dev)
    for label, (masks, coords) in zip(("uncertainty", "loss", "labels"), inputs):
        want = forward(libs["committed"], masks, coords)
        times = []
        for name in FORWARD + ("committed",):
            if not torch.equal(forward(libs[name], masks, coords), want):
                raise AssertionError(f"forward {name} {label}: other bits than the committed kernel's")
            times.append(f"{name} {cs.time_ms(lambda: forward(libs[name], masks, coords)):.4f}")
        cs.log(f"forward {label} {tuple(masks.shape)} P={coords.shape[2]} ms: " + ", ".join(times))
    masks, coords = inputs[1]
    b, n, h, w = masks.shape
    g = torch.from_numpy(rng.randn(b, n, coords.shape[2]).astype(np.float32)).to(dev)
    bunched = cs.bunched_coords(rng, coords, h, w)
    want, want_b = backward(libs["committed"], coords, g, h, w), backward(libs["committed"], bunched, g, h, w)
    names = ["committed"] + [k for k in VARIANTS if k not in FORWARD] + ["committed"]
    for name in names:
        if not (torch.equal(backward(libs[name], coords, g, h, w), want)
                and torch.equal(backward(libs[name], bunched, g, h, w), want_b)):
            raise AssertionError(f"backward {name}: other bits than the committed kernel's")
        ms = cs.time_ms(lambda: backward(libs[name], coords, g, h, w))
        ms_b = cs.time_ms(lambda: backward(libs[name], bunched, g, h, w), iters=3)
        cs.log(f"backward {name}: ms {ms:.4f}, bunched ms {ms_b:.4f}")
    backward(libs["phases"], coords, g, h, w)
    torch.cuda.synchronize()
    blocks = b * n * -(-h // 32)
    buf = (ctypes.c_longlong * (4 * blocks))()
    if libs["phases"].phase_copy(buf, 4 * blocks):
        raise RuntimeError("phase_copy failed")
    a = np.array(buf[:], dtype=np.float64).reshape(blocks, 4)
    mhz = float(smi.split(",")[-1].split()[0])
    cs.log("backward phases per block (" + f"{blocks} blocks, cycles mean / max, us at {mhz:.0f} MHz): " + "; ".join(
        f"{k} {a[:, i].mean():.0f} / {a[:, i].max():.0f} ({a[:, i].mean() / mhz:.2f} us)"
        for i, k in enumerate(("compaction", "lists", "gather"))) + f"; points kept per band {a[:, 3].mean():.0f}"
        f" / {a[:, 3].max():.0f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
