"""Bit-exact twins of the host resizers for uint8 images
(counterpart of `rgbdseg_tpu/ops/resize_exact.py`, plus PIL NEAREST).

The JAX package's host channel builders resize with two libraries: PIL
BILINEAR for the normalised colour and depth channels and cv2 INTER_LINEAR for
the gray depth that the gradient features are derived from; instance maps go
through PIL NEAREST. All three work on uint8 in integer arithmetic, and these
twins reproduce them exactly, on CPU and CUDA tensors alike, so a frame of any
camera size can be shipped as raw uint8 and resized where the channels are
built.

The tap positions and integer coefficients are computed on the host in numpy
(the shapes are known) and the passes run as a loop over taps: a gather of
each tap's source pixels and an int32 weighted sum. CUDA has no integer
matmul, and a float32 one is not exact here (the accumulators reach
255 * 2^22 ~ 2^30), so neither the JAX twin's int32 contraction nor a float
matmul would do.

- PIL BILINEAR (Pillow Resample.c, 8 bpc): a triangle filter whose support
  grows with the downscale factor, coefficients round(w * 2^22) after
  normalisation, the horizontal pass first with its result clipped to uint8,
  then the vertical one; each pass rounds with (+2^21) >> 22.
- cv2 INTER_LINEAR (OpenCV's fixed-point uint8 path): 2 taps, positions in
  float32, coefficients rint(fx * 2048), the horizontal pass kept as raw
  integers, the vertical one with OpenCV's staged cast ((b * (v >> 4)) >> 16
  per tap, then + 2 >> 2).
- PIL NEAREST (Pillow Geometry.c, `ImagingScaleAffine`): the source index of
  output pixel x is floor(x0 + x * s) with s = in / out, where Pillow forms the
  position by adding s in float64 once per pixel from x0 = s / 2; the twin
  repeats that sum, so the indices are Pillow's bit for bit.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch

_PIL_PREC = 22  # Pillow PRECISION_BITS = 32 - 8 - 2
_CV_BITS = 11  # OpenCV INTER_RESIZE_COEF_BITS


@lru_cache(maxsize=256)
def _pil_matrix(in_size: int, out_size: int) -> np.ndarray:
    """(out, in) int32 coefficient matrix per Pillow precompute_coeffs +
    normalize_coeffs_8bpc (triangle filter, support scaled by the ratio)."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = filterscale  # bilinear filter support = 1.0
    K = np.zeros((out_size, in_size), np.int32)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        ss = 1.0 / filterscale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size)
        k = np.array([max(1.0 - abs((x - center + 0.5) * ss), 0.0) for x in range(xmin, xmax)])
        s = k.sum()
        if s != 0:
            k /= s
        for i, v in enumerate(k):
            K[xx, xmin + i] = int(v * (1 << _PIL_PREC) + (0.5 if v >= 0 else -0.5))
    return K


@lru_cache(maxsize=256)
def _pil_taps(in_size: int, out_size: int) -> tuple[np.ndarray, np.ndarray]:
    """`_pil_matrix` as taps: (ntaps, out) source indices and int32 coefficients,
    tap t of output x being the t-th column of its window (coefficient 0 past it)."""
    K = _pil_matrix(in_size, out_size)
    nz = K != 0
    first = np.where(nz.any(1), nz.argmax(1), 0)
    ntaps = max(1, int((in_size - nz[:, ::-1].argmax(1) - first).max()))
    idx = np.minimum(first[None, :] + np.arange(ntaps)[:, None], in_size - 1)
    coef = np.take_along_axis(K.T, idx, axis=0)
    coef[first[None, :] + np.arange(ntaps)[:, None] >= in_size] = 0
    return idx.astype(np.int64), coef.astype(np.int32)


def _spatial_axes(img: torch.Tensor, has_channels) -> tuple[int, int]:
    """(H, W) axes of a channels-last array: (H, W), (H, W, C), (B, H, W[, C]).
    `has_channels=None` infers: 2-D never has channels, 3-D has them iff the last
    dimension is at most 4 (ambiguous for narrow images: pass the flag), 4-D and
    more always do."""
    if has_channels is None:
        has_channels = img.ndim >= 4 or (img.ndim == 3 and img.shape[-1] <= 4)
    ax_h = img.ndim - (3 if has_channels else 2)
    return ax_h, ax_h + 1


def _on(a: np.ndarray, x: torch.Tensor, axis: int) -> torch.Tensor:
    """A per-output-position host array on x's device, shaped to broadcast along `axis`."""
    shape = [1] * x.ndim
    shape[axis] = a.shape[-1]
    return torch.from_numpy(np.ascontiguousarray(a)).to(x.device).reshape(shape)


def _pil_pass(x: torch.Tensor, in_size: int, out_size: int, axis: int) -> torch.Tensor:
    """One Pillow resample pass along `axis`: int32 in [0, 255] -> int32 in [0, 255]."""
    idx, coef = _pil_taps(in_size, out_size)
    dev_idx = torch.from_numpy(idx).to(x.device)
    acc = None
    for t in range(idx.shape[0]):
        term = x.index_select(axis, dev_idx[t]) * _on(coef[t], x, axis)
        acc = term if acc is None else acc + term
    return ((acc + (1 << (_PIL_PREC - 1))) >> _PIL_PREC).clamp(0, 255)


def pil_resize_u8(img_u8: torch.Tensor, out_hw: tuple[int, int], has_channels: bool | None = None) -> torch.Tensor:
    """PIL ``Image.resize(..., BILINEAR)`` of uint8 images, channels-last; pass
    `has_channels` for 3-D arrays ((B, H, W) stacks against (H, W, C) images)."""
    h, w = out_hw
    ax_h, ax_w = _spatial_axes(img_u8, has_channels)
    x = img_u8.to(torch.int32)
    if img_u8.shape[ax_w] != w:  # horizontal first, as Pillow does
        x = _pil_pass(x, img_u8.shape[ax_w], w, ax_w)
    if img_u8.shape[ax_h] != h:
        x = _pil_pass(x, img_u8.shape[ax_h], h, ax_h)
    return x.to(torch.uint8)


@lru_cache(maxsize=256)
def _cv_taps(in_size: int, out_size: int):
    """(s0, s1, a, b) int32 arrays per OpenCV's classic uint8 fixed-point
    INTER_LINEAR: fxx in float32, coefficients rint(fx*2048) half-even,
    fractions unzeroed at borders, tap indices replicate-clamped."""
    scale = in_size / out_size
    s0 = np.zeros(out_size, np.int32)
    s1 = np.zeros(out_size, np.int32)
    a = np.zeros(out_size, np.int32)
    b = np.zeros(out_size, np.int32)
    one, sc = np.float32(1.0), np.float32(1 << _CV_BITS)
    for x in range(out_size):
        fxx = np.float32((x + 0.5) * scale - 0.5)
        sx = int(math.floor(fxx))
        fx = np.float32(fxx - np.float32(sx))
        a[x] = int(np.rint(np.float32((one - fx) * sc)))
        b[x] = int(np.rint(np.float32(fx * sc)))
        s0[x] = min(max(sx, 0), in_size - 1)
        s1[x] = min(max(sx + 1, 0), in_size - 1)
    return s0, s1, a, b


def cv2_resize_linear_u8(
    img_u8: torch.Tensor, out_hw: tuple[int, int], has_channels: bool | None = None
) -> torch.Tensor:
    """``cv2.resize(..., INTER_LINEAR)`` of uint8 images, channels-last; pass
    `has_channels` for ambiguous 3-D arrays (see `pil_resize_u8`)."""
    h, w = out_hw
    ax_h, ax_w = _spatial_axes(img_u8, has_channels)
    hs0, hs1, ha, hb = _cv_taps(img_u8.shape[ax_w], w)
    vs0, vs1, va, vb = _cv_taps(img_u8.shape[ax_h], h)
    x = img_u8.to(torch.int32)

    def take(arr, idx, axis):
        return arr.index_select(axis, torch.from_numpy(idx.astype(np.int64)).to(arr.device))

    t = _on(ha, x, ax_w) * take(x, hs0, ax_w) + _on(hb, x, ax_w) * take(x, hs1, ax_w)  # raw int, exact
    # OpenCV's uint8 vertical cast: per tap (b * (v >> 4)) >> 16, then + 2 >> 2
    out = ((_on(va, t, ax_h) * (take(t, vs0, ax_h) >> 4)) >> 16) + (
        (_on(vb, t, ax_h) * (take(t, vs1, ax_h) >> 4)) >> 16
    )
    return ((out + 2) >> 2).clamp(0, 255).to(torch.uint8)


@lru_cache(maxsize=256)
def _pil_nearest_indices(in_size: int, out_size: int) -> np.ndarray:
    """Pillow's NEAREST source index of each output position, as int64."""
    step = in_size / out_size
    pos = step * 0.5
    idx = np.empty(out_size, np.int64)
    for x in range(out_size):
        idx[x] = min(int(pos), in_size - 1)
        pos += step
    return idx


def pil_resize_nearest(img: torch.Tensor, out_hw: tuple[int, int], has_channels: bool | None = None) -> torch.Tensor:
    """PIL ``Image.resize(..., NEAREST)``, any dtype, channels-last (as `pil_resize_u8`)."""
    h, w = out_hw
    ax_h, ax_w = _spatial_axes(img, has_channels)
    for axis, size in ((ax_w, w), (ax_h, h)):
        if img.shape[axis] != size:
            idx = _pil_nearest_indices(img.shape[axis], size)
            img = img.index_select(axis, torch.from_numpy(idx).to(img.device))
    return img
