"""COCO run-length encoding, pycocotools-compatible
(a copy of `rgbdseg_tpu/inference/rle.py`).

- binary mask -> Fortran-order alternating run counts, starting with zeros;
- counts -> the compressed string of pycocotools (signed base-32 varint of the
  delta from the count two places back).

The counts-string codec runs in C (`rgbdseg_torch.native.rle`, built at first
use) where a C compiler is found, else in numpy; `codec()` says which and
why. The numpy functions `_encode_counts_np` / `_decode_counts_np` are the
plain version the native codec must equal.
"""

from __future__ import annotations

import numpy as np

from .. import native


def codec() -> str:
    """Which counts-string codec is in use: "native (...)" or "numpy (reason)"."""
    native.rle()
    return native.STATUS


def mask_to_counts(mask: np.ndarray) -> np.ndarray:
    """(H, W) bool/0-1 -> run counts (Fortran order, starting with 0-run)."""
    flat = np.asfortranarray(mask.astype(np.uint8)).reshape(-1, order="F")
    if flat.size == 0:
        return np.zeros((0,), np.int64)
    change = np.nonzero(np.diff(flat))[0] + 1
    boundaries = np.concatenate([[0], change, [flat.size]])
    counts = np.diff(boundaries).astype(np.int64)
    if flat[0] == 1:  # must start with a zero-run
        counts = np.concatenate([[0], counts])
    return counts


def counts_to_mask(counts, size_hw) -> np.ndarray:
    h, w = size_hw
    counts = np.asarray(counts, np.int64)
    vals = np.zeros(len(counts), np.uint8)
    vals[1::2] = 1
    flat = np.repeat(vals, counts)
    if flat.size != h * w:
        raise ValueError(f"RLE size mismatch: {flat.size} != {h * w}")
    return flat.reshape((h, w), order="F")


def _encode_counts_np(counts) -> str:
    out = []
    cnts = [int(c) for c in counts]
    for i, x in enumerate(cnts):
        if i > 2:
            x -= cnts[i - 2]
        more = True
        while more:
            c = x & 0x1F
            x >>= 5
            more = (x != -1) if (c & 0x10) else (x != 0)
            if more:
                c |= 0x20
            out.append(chr(c + 48))
    return "".join(out)


def _decode_counts_np(s: str) -> np.ndarray:
    cnts: list[int] = []
    i = 0
    n = len(s)
    while i < n:
        x = 0
        k = 0
        more = True
        while more:
            c = ord(s[i]) - 48
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            i += 1
            k += 1
            if not more and (c & 0x10):
                x |= -1 << (5 * k)
        if len(cnts) > 2:
            x += cnts[-2]
        cnts.append(x)
    return np.asarray(cnts, np.int64)


def encode_counts_string(counts: np.ndarray) -> str:
    """pycocotools rleToString parity (signed base-32 varint with delta)."""
    lib = native.rle()
    return lib.encode(np.asarray(counts, np.int64)) if lib is not None else _encode_counts_np(counts)


def decode_counts_string(s: str) -> np.ndarray:
    if s and (ord(s[-1]) - 48) & 0x20:
        raise ValueError("RLE counts string ends inside a count")
    lib = native.rle()
    return lib.decode(s) if lib is not None else _decode_counts_np(s)


def encode(mask: np.ndarray) -> dict:
    """binary (H, W) -> {"size": [H, W], "counts": str} (compressed RLE)."""
    h, w = mask.shape
    return {"size": [int(h), int(w)], "counts": encode_counts_string(mask_to_counts(mask))}


def decode(rle: dict) -> np.ndarray:
    counts = rle["counts"]
    if isinstance(counts, str):
        counts = decode_counts_string(counts)
    elif isinstance(counts, bytes):
        counts = decode_counts_string(counts.decode("utf-8"))
    return counts_to_mask(counts, rle["size"])


def area(rle: dict) -> int:
    counts = rle["counts"]
    if isinstance(counts, (str, bytes)):
        counts = decode_counts_string(counts if isinstance(counts, str) else counts.decode())
    return int(np.sum(counts[1::2]))


def mask_iou(a: dict, b: dict) -> float:
    ma, mb = decode(a).astype(bool), decode(b).astype(bool)
    inter = np.logical_and(ma, mb).sum()
    union = np.logical_or(ma, mb).sum()
    return float(inter) / float(union) if union else 0.0
