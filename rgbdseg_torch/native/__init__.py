"""Host accelerators in C, built at first use and bound with ctypes.

`rle()` returns the COCO counts-string codec of `rle.c`, compiled with
`cc -O2 -shared -fPIC` into `<repo>/build/native/` (named by a hash of the
source and the flags, so an edited source rebuilds) the first time it is
asked for. Where no C compiler is found it returns None and
`rgbdseg_torch.inference.rle` runs its numpy codec, which `STATUS` then
names with the reason. A compiler that is found and fails raises: a failed
build is never hidden behind the numpy codec. This is a host library, not a
device kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

_SRC = Path(__file__).resolve().parent / "rle.c"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CFLAGS = ["-O2", "-shared", "-fPIC"]

_RLE: list = []  # [codec or None] once `rle()` has run
STATUS = "not loaded"  # which codec `inference.rle` uses, and why


class RleCodec:
    """ctypes binding of rle.c's string codec."""

    def __init__(self, lib: ctypes.CDLL):
        self._encode = lib.rle_encode_string
        self._encode.argtypes = [ctypes.c_void_p, ctypes.c_long, ctypes.c_char_p]
        self._encode.restype = ctypes.c_long
        self._decode = lib.rle_decode_string
        self._decode.argtypes = [ctypes.c_char_p, ctypes.c_long, ctypes.c_void_p]
        self._decode.restype = ctypes.c_long

    def encode(self, counts: np.ndarray) -> str:
        counts = np.ascontiguousarray(counts, np.int64)
        out = ctypes.create_string_buffer(13 * len(counts) + 1)
        n = self._encode(counts.ctypes.data, len(counts), out)
        return out.raw[:n].decode("ascii")

    def decode(self, s: str) -> np.ndarray:
        raw = s.encode("ascii")
        counts = np.empty(max(len(raw), 1), np.int64)
        n = self._decode(raw, len(raw), counts.ctypes.data)
        return counts[:n].copy()


def _build(cc: str) -> Path:
    """Compile rle.c into BUILD_DIR unless it is there; returns the library's path."""
    tag = hashlib.sha1(_SRC.read_bytes() + " ".join([cc, *CFLAGS]).encode()).hexdigest()[:12]
    target = BUILD_DIR / f"librle-{tag}.so"
    if target.exists():
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([cc, *CFLAGS, "-o", str(tmp), str(_SRC)], capture_output=True, text=True, timeout=120)
    if proc.returncode != 0:
        raise RuntimeError(f"{cc} failed to build {_SRC.name} (exit {proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, target)
    return target


def rle() -> Optional[RleCodec]:
    """The native codec, built and loaded at the first call; None without a C compiler."""
    global STATUS
    if not _RLE:
        cc = shutil.which(os.environ.get("CC", "cc"))
        if cc is None:
            STATUS = f"numpy (no C compiler: {os.environ.get('CC', 'cc')} not found)"
            _RLE.append(None)
        else:
            path = _build(cc)
            _RLE.append(RleCodec(ctypes.CDLL(str(path))))
            STATUS = f"native ({path.name})"
    return _RLE[0]
