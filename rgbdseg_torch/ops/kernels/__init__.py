"""Hand-written CUDA kernels for Hopper: build, load and count launches.

Each kernel lives in `rgbdseg_torch/csrc/<name>.cu` behind a plain C
interface. At first use `load(name)` compiles it with nvcc for `sm_90a` into a
shared library under `<repo>/build/kernels/` (named by a hash of the source and
flags, so an edited source rebuilds) and binds it with ctypes. `build_all()`
starts one nvcc per source, all together, and waits for them.

The kernel modules (`deformable`, `masked_attention`) each hold the plain
PyTorch version of their function, the wrapper, and a source note. A wrapper
takes the plain version only for CPU tensors; for CUDA tensors it launches the
kernel or raises. `LAUNCHES` counts kernel launches per wrapper: a plain
integer each, bumped only where the kernel is launched (once per call, also
where one call is two launches, as K3's split and combine are).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

# Kernel name -> C entry point and its ctypes argument types.
_SIGNATURES = {
    "deformable": (
        "rgbd_deform_sample",
        [ctypes.c_void_p] * 4 + [ctypes.POINTER(ctypes.c_int)] + [ctypes.c_int] * 9 + [ctypes.c_void_p],
    ),
    "masked_attention": (
        "rgbd_masked_cross_attention",
        [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8 + [ctypes.c_void_p],
    ),
}

LAUNCHES = {"deformable": 0, "masked_attention": 0}

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


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    tag = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{tag}.so"


def _start_build(name: str):
    """Start nvcc for one source; returns (process, tmp path, target) or None if built."""
    target = _target(name)
    if target.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp, target


def _finish_build(name: str, job) -> None:
    proc, tmp, target = job
    out, _ = proc.communicate()
    BUILD_LOG[name] = out
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu (exit {proc.returncode}):\n{out}")
    os.replace(tmp, target)


def build_all() -> float:
    """Compile every kernel source in parallel; returns wall seconds."""
    t0 = time.perf_counter()
    jobs = {name: _start_build(name) for name in _SIGNATURES}
    for name, job in jobs.items():
        if job is not None:
            _finish_build(name, job)
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The bound shared library for kernel `name`, built at first use."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    job = _start_build(name)
    if job is not None:
        _finish_build(name, job)
    lib = ctypes.CDLL(str(_target(name)))
    fn_name, argtypes = _SIGNATURES[name]
    fn = getattr(lib, fn_name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    _LIBS[name] = lib
    return lib


def launch(name: str, *args) -> None:
    """Call kernel `name`'s C entry point on the current stream; raise on a launch error."""
    lib = load(name)
    fn_name, _ = _SIGNATURES[name]
    err = getattr(lib, fn_name)(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{fn_name} launch failed: cudaError {err}")
    LAUNCHES[name] += 1


def check_cuda_tensor(t: torch.Tensor, name: str, dtypes) -> None:
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} has dtype {t.dtype}; the kernel takes {dtypes}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
