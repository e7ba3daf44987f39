"""Host accelerators in C, built at first use and bound with ctypes.

Each source is compiled with `cc -O2 -shared -fPIC` into
`<repo>/build/native/` (named by a hash of the source and the flags, so an
edited source rebuilds) the first time it is asked for. These are host
libraries, not device kernels.

- `rle()` returns the COCO counts-string codec of `rle.c`. Where no C
  compiler is found it returns None and `rgbdseg_torch.inference.rle` runs
  its numpy codec, which `STATUS` then names with the reason. A compiler that
  is found and fails raises: a failed build is never hidden behind the numpy
  codec.
- `contours()` returns the border follower of `contours.c`, cv2's
  `findContours(RETR_CCOMP, CHAIN_APPROX_SIMPLE)` and `contourArea`. It has
  no second implementation: without a compiler, or when the build fails, it
  raises.
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

_HERE = Path(__file__).resolve().parent
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CFLAGS = ["-O2", "-shared", "-fPIC"]

_RLE: list = []  # [codec or None] once `rle()` has run
_CONTOURS: list = []  # [tracer] once `contours()` has run
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


class ContourTracer:
    """ctypes binding of contours.c."""

    def __init__(self, lib: ctypes.CDLL):
        self._lib = lib
        lib.contours_find.argtypes = [ctypes.c_void_p, ctypes.c_long, ctypes.c_long]
        lib.contours_find.restype = ctypes.c_void_p
        lib.contours_count.argtypes = lib.contours_points.argtypes = [ctypes.c_void_p]
        lib.contours_count.restype = lib.contours_points.restype = ctypes.c_long
        lib.contours_copy.argtypes = [ctypes.c_void_p] * 4
        lib.contours_copy.restype = None
        lib.contours_free.argtypes = [ctypes.c_void_p]
        lib.contours_free.restype = None
        lib.contour_area.argtypes = [ctypes.c_void_p, ctypes.c_long]
        lib.contour_area.restype = ctypes.c_double

    def find(self, mask: np.ndarray) -> tuple[list[np.ndarray], np.ndarray]:
        """(contours, hierarchy) of a 2-D mask as cv2's findContours(RETR_CCOMP,
        CHAIN_APPROX_SIMPLE) gives them: contours (n, 1, 2) int32 arrays,
        hierarchy (k, 4) int32 rows (next, previous, first child, parent)."""
        mask = np.ascontiguousarray(mask, np.uint8)
        if mask.ndim != 2:
            raise ValueError(f"contours of a 2-D mask; got shape {mask.shape}")
        handle = self._lib.contours_find(mask.ctypes.data, mask.shape[0], mask.shape[1])
        if not handle:
            raise MemoryError("contours.c ran out of memory")
        try:
            k = self._lib.contours_count(handle)
            pts = np.empty((max(self._lib.contours_points(handle), 1), 2), np.int32)
            offsets = np.empty(k + 1, np.int64)
            hierarchy = np.empty((max(k, 1), 4), np.int32)
            self._lib.contours_copy(handle, pts.ctypes.data, offsets.ctypes.data, hierarchy.ctypes.data)
        finally:
            self._lib.contours_free(handle)
        return [pts[offsets[i]:offsets[i + 1]].reshape(-1, 1, 2) for i in range(k)], hierarchy[:k]

    def area(self, contour: np.ndarray) -> float:
        """cv2.contourArea of an integer contour: float64 shoelace, unsigned."""
        pts = np.ascontiguousarray(contour, np.int32).reshape(-1, 2)
        return float(self._lib.contour_area(pts.ctypes.data, len(pts)))


def _build(cc: str, src: Path) -> Path:
    """Compile `src` into BUILD_DIR unless it is there; returns the library's path."""
    tag = hashlib.sha1(src.read_bytes() + " ".join([cc, *CFLAGS]).encode()).hexdigest()[:12]
    target = BUILD_DIR / f"lib{src.stem}-{tag}.so"
    if target.exists():
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([cc, *CFLAGS, "-o", str(tmp), str(src)], capture_output=True, text=True, timeout=120)
    if proc.returncode != 0:
        raise RuntimeError(f"{cc} failed to build {src.name} (exit {proc.returncode}):\n{proc.stderr}")
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
            path = _build(cc, _HERE / "rle.c")
            _RLE.append(RleCodec(ctypes.CDLL(str(path))))
            STATUS = f"native ({path.name})"
    return _RLE[0]


def contours() -> ContourTracer:
    """The border follower, built and loaded at the first call; raises without a C compiler."""
    if not _CONTOURS:
        cc = shutil.which(os.environ.get("CC", "cc"))
        if cc is None:
            raise RuntimeError(f"no C compiler ({os.environ.get('CC', 'cc')} not found) to build contours.c")
        _CONTOURS.append(ContourTracer(ctypes.CDLL(str(_build(cc, _HERE / "contours.c")))))
    return _CONTOURS[0]
