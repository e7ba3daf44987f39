"""Hand-written CUDA kernels for Hopper: build, load and count launches.

Each kernel lives in `rgbdseg_torch/csrc/<name>.cu` behind a plain C
interface (helpers shared by several sources in `csrc/*.cuh`); an entry point
may share another's source (`_SOURCES`: the point-sampling backward lives in
`point_sample.cu`, E-DSAM's statistics and apply kernels in
`edsam_extract.cu`). At first use `load(name)` compiles the source with nvcc
for `sm_90a` into a shared library under `<repo>/build/kernels/` (named by a
hash of the source, the headers and the flags, so an edited source or header
rebuilds) and binds it with ctypes. `build_all()` starts one nvcc per source,
all together, and waits for them.

The kernel modules (`deformable`, `masked_attention`, `point_sample`,
`edsam_extract`) each hold the plain PyTorch versions of their function and
its gradient, the wrapper (a `torch.autograd.Function` whose forward and
backward are kernels; E-DSAM's extract stage has no gradient, and its backward
raises), and a source note. A wrapper takes the plain versions only for CPU
tensors; for CUDA tensors it launches the kernel or raises. `LAUNCHES` counts kernel launches per entry
point, the backward ones (`*_bwd`) apart from the forward ones: a plain integer
each, bumped only where the kernel is launched (once per call, also where one
call is two launches, as K3's split and combine are). `FLOPS` sums, per
entry point, the floating-point operations of the launches' dense formulas
(every sample and every key counted), for `total_flos`, which torch's
FlopCounterMode cannot see in a ctypes launch. Both are groups of the port's
counter registry (`utils/trace.py`, as `kernels.LAUNCHES` and
`kernels.FLOPS`), whose spans `op.<kernel>` and `op.<kernel>_bwd` the
wrappers open around each call and each backward.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

import torch

from ...utils.trace import counters

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

# Kernel name (its source's stem) -> C entry point and its ctypes argument types.
_SIGNATURES = {
    "deformable": (
        "rgbd_deform_sample",
        [ctypes.c_void_p] * 4 + [ctypes.POINTER(ctypes.c_int)] + [ctypes.c_int] * 9 + [ctypes.c_void_p],
    ),
    "deformable_bwd": (
        "rgbd_deform_sample_bwd",
        [ctypes.c_void_p] * 8 + [ctypes.c_longlong, ctypes.POINTER(ctypes.c_int)] + [ctypes.c_int] * 9
        + [ctypes.c_void_p],
    ),
    "masked_attention": (
        "rgbd_masked_cross_attention",
        [ctypes.c_void_p] * 9 + [ctypes.c_int] * 8 + [ctypes.c_void_p],
    ),
    "masked_attention_bwd": (
        "rgbd_masked_cross_attention_bwd",
        [ctypes.c_void_p] * 12 + [ctypes.c_int] * 8 + [ctypes.c_void_p],
    ),
    "point_sample": ("rgbd_point_sample", [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]),
    "point_sample_bwd": ("rgbd_point_sample_bwd", [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]),
    "edsam_extract": (
        "rgbd_edsam_extract",
        [ctypes.c_void_p] * 8 + [ctypes.c_float] + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p],
    ),
    "edsam_extract_stats": ("rgbd_edsam_extract_stats", [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3 + [ctypes.c_void_p]),
    "edsam_extract_apply": (
        "rgbd_edsam_extract_apply",
        [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3 + [ctypes.c_float] * 2 + [ctypes.c_void_p],
    ),
}
# Entry point -> its source's stem, where that is not its own name.
_SOURCES = {"point_sample_bwd": "point_sample", "edsam_extract_stats": "edsam_extract",
            "edsam_extract_apply": "edsam_extract"}

LAUNCHES = counters("kernels.LAUNCHES", _SIGNATURES)
FLOPS = counters("kernels.FLOPS", _SIGNATURES)

_LIBS: dict[str, ctypes.CDLL] = {}
BUILD_LOG: dict[str, str] = {}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels are built with nvcc at first use")


def _source(name: str) -> str:
    return _SOURCES.get(name, name)


def _target(source: str) -> Path:
    src = (CSRC / f"{source}.cu").read_bytes() + b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    tag = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{source}-{tag}.so"


def _start_build(source: str):
    """Start nvcc for one source; returns (process, tmp path, target) or None if built."""
    target = _target(source)
    if target.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{source}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp, target


def _finish_build(source: str, job) -> None:
    proc, tmp, target = job
    out, _ = proc.communicate()
    BUILD_LOG[source] = out
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {source}.cu (exit {proc.returncode}):\n{out}")
    os.replace(tmp, target)


def build_all() -> float:
    """Compile every kernel source in parallel; returns wall seconds."""
    t0 = time.perf_counter()
    jobs = {source: _start_build(source) for source in dict.fromkeys(map(_source, _SIGNATURES))}
    for source, job in jobs.items():
        if job is not None:
            _finish_build(source, job)
    return time.perf_counter() - t0


def ptxas_report(log: str) -> list[str]:
    """One line per compiled kernel from nvcc's `-Xptxas -v` output: its
    demangled name, registers, stack frame, spill stores and loads, and shared
    memory (what decides occupancy and local-memory traffic)."""
    funcs: dict[str, dict] = {}
    cur = None
    for ln in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?([\w$]+)'?", ln)
        if m:
            cur = funcs.setdefault(m.group(1), {})
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m:
            cur.update(stack=int(m.group(1)), spill_st=int(m.group(2)), spill_ld=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            cur["regs"] = int(m.group(1))
            smem = re.search(r"(\d+) bytes smem", ln)
            cur["smem"] = int(smem.group(1)) if smem else 0
    names = _demangle(list(funcs))
    return [f"{names[k]}: {f.get('regs')} registers, {f.get('stack')} bytes stack frame, {f.get('spill_st')} / "
            f"{f.get('spill_ld')} bytes spill stores / loads, {f.get('smem')} bytes static smem"
            for k, f in funcs.items() if "regs" in f]


def _demangle(names: list[str]) -> dict[str, str]:
    """c++filt's names where it is installed (the mangled ones where not)."""
    tool = shutil.which("c++filt") or shutil.which("cu++filt")
    if not tool or not names:
        return {n: n for n in names}
    out = subprocess.run([tool], input="\n".join(names), capture_output=True, text=True).stdout.splitlines()
    if len(out) != len(names):
        return {n: n for n in names}
    return {n: re.sub(r"\(anonymous namespace\)::|\(.*\)$", "", d) for n, d in zip(names, out)}


def load(name: str) -> ctypes.CDLL:
    """The bound shared library for kernel `name`, built at first use."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    source = _source(name)
    job = _start_build(source)
    if job is not None:
        _finish_build(source, job)
    lib = ctypes.CDLL(str(_target(source)))
    fn_name, argtypes = _SIGNATURES[name]
    fn = getattr(lib, fn_name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    _LIBS[name] = lib
    return lib


def launch(name: str, *args, flops: int = 0) -> None:
    """Call kernel `name`'s C entry point on the current stream; raise on a launch
    error. `flops`: the launch's operations by the kernel's dense formula."""
    lib = load(name)
    fn_name, _ = _SIGNATURES[name]
    err = getattr(lib, fn_name)(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{fn_name} launch failed: cudaError {err}")
    LAUNCHES[name] += 1
    FLOPS[name] += flops


def check_cuda_tensor(t: torch.Tensor, name: str, dtypes) -> None:
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} has dtype {t.dtype}; the kernel takes {dtypes}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
