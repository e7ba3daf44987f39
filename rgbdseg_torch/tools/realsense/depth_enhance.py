"""Depth-image enhancement ops used by the frame curator, in torch on a device
(counterpart of `rgbdseg_tpu/tools/realsense/depth_enhance.py`, without cv2).

Parity targets (reference: intelRealSense/display.py):
- adaptive histogram equalization (AHE/CLAHE)        (:33-42)
- linear transform                                   (:45-54)
- gamma transform                                    (:57-67)
- Laplacian sharpening                               (:70-79)
- Gaussian-subtract (unsharp) enhancement            (:82-90)
- histogram equalization                             (:23-30)

Each op takes a uint8 (H, W) tensor and computes on its device what the cv2
call of the JAX tool computes on uint8, bit for bit (OpenCV 4/5's scalar
definitions; the integer work in int32/int64, float32 where cv2 rounds in
float32, one torch op per rounding so no device fuses two of them):
- `equalizeHist`: a constant image stays; else the LUT rounds
  sum * (255 / (total - first count)) in float32, half to even;
- CLAHE (imgproc/src/clahe.cpp): the image padded by reflect-101 up to a
  multiple of the tile grid when either side is not one (each side by a
  whole grid's rows or columns less its remainder), the clip limit
  max(int(clip * tileArea / 256), 1), the clipped counts spread evenly with
  the residual one by one at a stride, the LUT scaled by 255 / tileArea in
  float32, the tiles' LUTs interpolated bilinearly in float32;
- `convertScaleAbs`: x * alpha + beta with one rounding to float32 (cv2's
  SIMD and scalar paths both fuse the multiply-add where FMA is built in), the
  absolute value rounded half to even and saturated; 2**31 and more give 0
  (the integer conversion's overflow value);
- the gamma LUT is built on the host in numpy (float64 pow, truncated), as the
  JAX tool builds it, and applied on the device;
- `Laplacian(CV_16S, ksize=3)`: [[2, 0, 2], [0, -8, 0], [2, 0, 2]] over a
  reflect-101 border, in integers;
- `GaussianBlur(ksize, 0)` on uint8: OpenCV's fixed-point path, the
  small-kernel table for ksize 1, 3, 5 and 7 in 8.8 fixed point, both passes
  summed exactly and rounded half up at the 16 fractional bits; other sizes
  raise.
"""

from __future__ import annotations

import numpy as np
import torch

# OpenCV's small Gaussian kernels (getGaussianKernel, sigma <= 0) in 8.8 fixed point
_SMALL_GAUSSIAN = {1: (256,), 3: (64, 128, 64), 5: (16, 64, 96, 64, 16), 7: (8, 28, 56, 72, 56, 28, 8)}


def reflect101(n: int, lo: int, hi: int) -> np.ndarray:
    """Source indices of positions -lo .. n + hi - 1 under OpenCV's
    BORDER_REFLECT_101 (borderInterpolate)."""
    p = np.arange(-lo, n + hi)
    if n == 1:
        return np.zeros_like(p)
    while ((p < 0) | (p >= n)).any():
        p = np.where(p < 0, -p, np.where(p >= n, 2 * (n - 1) - p, p))
    return p


def _padded(x: torch.Tensor, top: int, bottom: int, left: int, right: int) -> torch.Tensor:
    h, w = x.shape
    rows = torch.from_numpy(reflect101(h, top, bottom)).to(x.device)
    cols = torch.from_numpy(reflect101(w, left, right)).to(x.device)
    return x[rows][:, cols]


def _f32(v, device) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32, device=device)


def _saturate_u8(v: torch.Tensor) -> torch.Tensor:
    """cv2's saturate_cast<uchar> of float32: rounded half to even, clamped."""
    return torch.round(v).clamp_(0, 255).to(torch.uint8)


def u16_to_device(depth: np.ndarray, device) -> torch.Tensor:
    """A uint16 array (a z16 depth frame) on the device as int32, uploaded as
    its int16 bits (torch's uint16 has few kernels)."""
    bits = torch.from_numpy(np.ascontiguousarray(depth, np.uint16).view(np.int16)).to(device)
    return bits.to(torch.int32) & 0xFFFF


def convert_scale_abs(x: torch.Tensor, alpha: float = 1.0, beta: float = 0.0) -> torch.Tensor:
    """``cv2.convertScaleAbs(x, alpha=alpha, beta=beta)`` of an integer tensor
    of at most 16 bits (uint8, int16, or uint16 values in int32) or a float32
    one -> uint8: |x * alpha + beta| with the multiply-add rounded once to
    float32."""
    a, b = float(np.float32(alpha)), float(np.float32(beta))
    p = x.to(torch.float64) * a  # exact: a float32 times an integer of <= 16 bits or a float32 times 1
    s = p + b
    r = s.to(torch.float32)
    if b != 0.0:
        # s is p + b rounded to float64; where that rounding left s exactly
        # halfway between two float32 values, the exact sum lies on the side
        # of its rounding error, and float32 rounding of s may have gone the
        # other way (double rounding)
        bb = s - p
        err = (p - (s - bb)) + (b - bb)
        rd = r.to(torch.float64)
        inf = torch.full_like(r, float("inf"))
        other = torch.nextafter(r, torch.where(s > rd, inf, -inf))
        tie = (s * 2 == rd + other.to(torch.float64)) & (err != 0)
        r = torch.where(tie & ((err > 0) == (other > r)), other, r)
    v = r.abs()
    return torch.where(v >= 2.0 ** 31, torch.zeros_like(v), v).round_().clamp_(0, 255).to(torch.uint8)


def hist_equalize(gray: torch.Tensor) -> torch.Tensor:
    """``cv2.equalizeHist`` of a uint8 (H, W) tensor."""
    g = gray.reshape(-1).long()
    hist = torch.bincount(g, minlength=256)
    first = (hist > 0).long().argmax().reshape(1)  # gathered, not indexed: no host sync
    rest = g.numel() - hist.gather(0, first)  # pixels above the lowest level
    scale = (255.0 / rest.to(torch.float64)).to(torch.float32)  # 255.f / rest: one float32 rounding
    cum = torch.cumsum(hist, 0)
    lut = _saturate_u8((cum - cum.gather(0, first)).to(torch.float32) * scale)
    lut = torch.where(rest == 0, first.to(torch.uint8), lut)  # a constant image keeps its level
    return lut[g].reshape(gray.shape)


def adaptive_hist_equalize(gray: torch.Tensor, clip_limit: float = 2.0, tile: int = 8) -> torch.Tensor:
    """``cv2.createCLAHE(clip_limit, (tile, tile)).apply`` of a uint8 (H, W) tensor."""
    h, w = gray.shape
    dev = gray.device
    src = gray
    if h % tile or w % tile:
        src = _padded(gray, 0, tile - h % tile, 0, tile - w % tile)
    th, tw = src.shape[0] // tile, src.shape[1] // tile
    area = th * tw
    # per-tile histograms
    ty = torch.arange(src.shape[0], device=dev) // th
    tx = torch.arange(src.shape[1], device=dev) // tw
    key = ((ty[:, None] * tile + tx[None, :]) * 256 + src.long()).reshape(-1)
    hist = torch.bincount(key, minlength=tile * tile * 256).reshape(tile * tile, 256)
    limit = max(int(clip_limit * area / 256), 1) if clip_limit > 0 else 0
    if limit > 0:
        clipped = (hist - limit).clamp(min=0).sum(1, keepdim=True)
        hist = hist.clamp(max=limit) + clipped // 256
        residual = clipped % 256
        step = (256 // residual.clamp(min=1)).clamp(min=1)
        bins = torch.arange(256, device=dev)[None, :]
        hist = hist + ((bins % step == 0) & (bins // step < residual)).long()
    lut = _saturate_u8(torch.cumsum(hist, 1).to(torch.float32) * _f32(np.float32(255) / np.float32(area), dev))
    lut = lut.to(torch.float32).reshape(-1)

    def axis(n, size):  # cv2's float32 tile coordinates of each pixel
        t = np.arange(n, dtype=np.float32) * (np.float32(1) / np.float32(size)) - np.float32(0.5)
        t1 = np.floor(t).astype(np.int64)
        a = (t - t1.astype(np.float32)).astype(np.float32)
        return (torch.from_numpy(np.maximum(t1, 0)).to(dev), torch.from_numpy(np.minimum(t1 + 1, tile - 1)).to(dev),
                torch.from_numpy(a).to(dev), torch.from_numpy(np.float32(1) - a).to(dev))

    y1, y2, ya, ya1 = axis(h, th)
    x1, x2, xa, xa1 = axis(w, tw)
    v = gray.long()
    row1, row2 = (y1 * tile)[:, None], (y2 * tile)[:, None]

    def at(row, col):
        return lut[(row + col[None, :]) * 256 + v]

    top = at(row1, x1) * xa1 + at(row1, x2) * xa
    bottom = at(row2, x1) * xa1 + at(row2, x2) * xa
    return _saturate_u8(top * ya1[:, None] + bottom * ya[:, None])


def linear_transform(gray: torch.Tensor, alpha: float = 1.5, beta: float = 0.0) -> torch.Tensor:
    return convert_scale_abs(gray, alpha=alpha, beta=beta)


def gamma_lut(gamma: float = 0.5) -> np.ndarray:
    """The JAX tool's gamma table, on the host as it builds it."""
    return np.clip(((np.arange(256) / 255.0) ** gamma) * 255.0, 0, 255).astype(np.uint8)


def gamma_transform(gray: torch.Tensor, gamma: float = 0.5) -> torch.Tensor:
    return torch.from_numpy(gamma_lut(gamma)).to(gray.device)[gray.long()]


def laplacian(gray: torch.Tensor) -> torch.Tensor:
    """``cv2.Laplacian(gray, cv2.CV_16S, ksize=3)`` -> int16."""
    p = _padded(gray, 1, 1, 1, 1).to(torch.int32)
    lap = 2 * (p[:-2, :-2] + p[:-2, 2:] + p[2:, :-2] + p[2:, 2:]) - 8 * p[1:-1, 1:-1]
    return lap.to(torch.int16)


def laplacian_sharpen(gray: torch.Tensor) -> torch.Tensor:
    return convert_scale_abs(gray.to(torch.int16) - laplacian(gray))


def gaussian_blur(gray: torch.Tensor, ksize: int = 5) -> torch.Tensor:
    """``cv2.GaussianBlur(gray, (ksize, ksize), 0)`` of uint8, fixed point."""
    if ksize not in _SMALL_GAUSSIAN:
        raise ValueError(f"GaussianBlur with sigma 0 is ported for ksize {sorted(_SMALL_GAUSSIAN)}; got {ksize}")
    k, r = _SMALL_GAUSSIAN[ksize], ksize // 2
    h, w = gray.shape
    p = _padded(gray, r, r, r, r).to(torch.int32)
    rows = sum(c * p[:, j:j + w] for j, c in enumerate(k))
    total = sum(c * rows[i:i + h] for i, c in enumerate(k))
    return ((total + (1 << 15)) >> 16).to(torch.uint8)


def gaussian_subtract(gray: torch.Tensor, ksize: int = 5, weight: float = 1.0) -> torch.Tensor:
    blur = gaussian_blur(gray, ksize)
    g = gray.to(torch.float32)
    sharp = g + _f32(weight, gray.device) * (g - blur.to(torch.float32))  # float32, one rounding per op
    return convert_scale_abs(sharp)


ENHANCEMENTS = {
    "eq": hist_equalize,
    "ahe": adaptive_hist_equalize,
    "lt": linear_transform,
    "gamma": gamma_transform,
    "laplace": laplacian_sharpen,
    "gaussian": gaussian_subtract,
}


def enhance_all(gray: torch.Tensor) -> dict[str, torch.Tensor]:
    return {name: fn(gray) for name, fn in ENHANCEMENTS.items()}


# cv2.applyColorMap's tables, built as OpenCV builds them (imgproc/src/colormap.cpp):
# a definition sampled at n points of linspace(0, 1, n), interpolated in float32
# to 256 levels by its interp1, scaled by 255 and rounded half to even; BGR order.
def _linspace(n: int) -> np.ndarray:
    step = np.float32(1) / np.float32(n - 1)
    return np.arange(n, dtype=np.float32) * step


def _interp1(xs: np.ndarray, ys: np.ndarray, xi: np.ndarray) -> np.ndarray:
    out = np.empty(len(xi), np.float32)
    for i, x in enumerate(xi):
        lo, hi = 0, len(xs) - 1
        while hi - lo > 1:  # OpenCV's search: an x on a sample point takes the interval below it
            c = lo + ((hi - lo) >> 1)
            lo, hi = (c, hi) if x > xs[c] else (lo, c)
        out[i] = ys[lo] + (x - xs[lo]) * (ys[hi] - ys[lo]) / (xs[hi] - xs[lo])
    return out


def _colormap(r: np.ndarray, g: np.ndarray, b: np.ndarray) -> np.ndarray:
    xs, xi = _linspace(len(r)), _linspace(256)
    return np.stack([np.rint(np.float32(255) * _interp1(xs, c.astype(np.float32), xi)).clip(0, 255)
                     for c in (b, g, r)], 1).astype(np.uint8)


def _jet() -> np.ndarray:
    x = np.arange(256) / 255.0
    return _colormap(*(np.clip(np.minimum(4 * x - s, 3 + s - 4 * x), 0, 1) for s in (1.5, 0.5, -0.5)))


def _bone() -> np.ndarray:
    x = np.arange(64) / 63.0  # MATLAB's bone(64): (7 gray + hot reversed) / 8
    hot = (np.clip(8 / 3 * x, 0, 1), np.clip(8 / 3 * x - 1, 0, 1), np.clip(4 * x - 3, 0, 1))
    return _colormap((7 * x + hot[2]) / 8, (7 * x + hot[1]) / 8, (7 * x + hot[0]) / 8)


COLORMAP_JET, COLORMAP_BONE = _jet(), _bone()


def apply_colormap(gray: torch.Tensor, table: np.ndarray) -> torch.Tensor:
    """``cv2.applyColorMap(gray, map)`` of a uint8 (H, W) tensor -> (H, W, 3) BGR."""
    return torch.from_numpy(table).to(gray.device)[gray.long()]
