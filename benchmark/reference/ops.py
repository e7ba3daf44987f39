"""The reference's operations: resizes and pools, Rec.601 grayscale, the
DSAM depth decomposition, the Sobel gradient features, the sine position
embedding, drop path and dropout, and the plain versions of the three
sampling and attention operations that the port runs as hand kernels
(deformable sampling with the JAX package's tent gradient, masked
cross-attention, point sampling). Frozen copies of the port's plain
arithmetic: each gives the port's numbers in float32 on any device.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .lowp import q as _q

# --- resizes and pools (the port's ops/resize.py) ---


def _linear_weights(out_size: int, in_size: int, device):
    """(lo_idx, hi_idx, hi_weight) for 1-D linear interpolation."""
    i = torch.arange(out_size, dtype=torch.float32, device=device)
    src = (i + 0.5) * (in_size / out_size) - 0.5
    src = src.clamp(0.0, in_size - 1)
    lo = torch.floor(src)
    w = src - lo
    lo = lo.long()
    hi = (lo + 1).clamp(max=in_size - 1)
    return lo, hi, w


def resize_bilinear(x: torch.Tensor, size: tuple[int, int]) -> torch.Tensor:
    """Bilinear resize of (..., H, W, C); rows first, then columns."""
    out_h, out_w = size
    *lead, in_h, in_w, c = x.shape
    if (in_h, in_w) == (out_h, out_w):
        return x
    lo_y, hi_y, wy = _linear_weights(out_h, in_h, x.device)
    lo_x, hi_x, wx = _linear_weights(out_w, in_w, x.device)
    x = x.reshape(-1, in_h, in_w, c)
    wy = wy.to(x.dtype)[None, :, None, None]
    rows = x[:, lo_y] * (1 - wy) + x[:, hi_y] * wy
    wx = wx.to(x.dtype)[None, None, :, None]
    out = rows[:, :, lo_x] * (1 - wx) + rows[:, :, hi_x] * wx
    return out.reshape(*lead, out_h, out_w, c)


def nearest_indices(out_size: int, in_size: int, device=None) -> torch.Tensor:
    """torch ``mode='nearest'`` source index ``floor(dst * in/out)``, in float32."""
    src = torch.arange(out_size, dtype=torch.float32, device=device) * (in_size / out_size)
    return src.long().clamp(max=in_size - 1)


def resize_nearest(x: torch.Tensor, size: tuple[int, int]) -> torch.Tensor:
    """Nearest resize of (..., H, W, C)."""
    out_h, out_w = size
    *lead, in_h, in_w, c = x.shape
    if (in_h, in_w) == (out_h, out_w):
        return x
    x = x.reshape(-1, in_h, in_w, c)
    out = x[:, nearest_indices(out_h, in_h, x.device)][:, :, nearest_indices(out_w, in_w, x.device)]
    return out.reshape(*lead, out_h, out_w, c)


def _adaptive(fn, x: torch.Tensor, size: tuple[int, int]) -> torch.Tensor:
    *lead, in_h, in_w, c = x.shape
    # NCHW-contiguous input: on channels-last strides the CUDA average pool takes
    # its NHWC kernel, 30.8 ms for the E-DSAM pool of a 480x640 train batch
    # against 0.8 ms for the NCHW one.
    y = fn(x.reshape(-1, in_h, in_w, c).permute(0, 3, 1, 2).contiguous(), size)
    return y.permute(0, 2, 3, 1).reshape(*lead, *size, c)


def adaptive_max_pool2d(x: torch.Tensor, size: tuple[int, int]) -> torch.Tensor:
    """torch ``adaptive_max_pool2d`` on (..., H, W, C) (DSAM mask downsampling)."""
    return _adaptive(F.adaptive_max_pool2d, x, tuple(size))


def adaptive_avg_pool2d(x: torch.Tensor, size: tuple[int, int]) -> torch.Tensor:
    """torch ``adaptive_avg_pool2d`` on (..., H, W, C) (E-DSAM predictor)."""
    return _adaptive(F.adaptive_avg_pool2d, x, tuple(size))


# --- grayscale (ops/image.py, float32) ---

REC601 = (0.299, 0.587, 0.114)


def to_grayscale(x: torch.Tensor) -> torch.Tensor:
    """Channels-last RGB (..., H, W, 3) -> (..., H, W): three products summed in a fixed order."""
    if x.shape[-1] == 1:
        return x[..., 0]
    r, g, b = REC601
    return x[..., 0] * r + x[..., 1] * g + x[..., 2] * b


# --- the DSAM depth decomposition (ops/depth_decomp.py) ---


def depth_histogram(depth: torch.Tensor, bins: int = 512):
    """(B, H, W) -> (hist (B, bins) float32, lo (B,), width (B,)); bin i's center is lo + (i+0.5)*width."""
    b = depth.shape[0]
    flat = depth.reshape(b, -1).float()
    finite = ~torch.isnan(flat)
    lo = torch.where(finite, flat, torch.inf).amin(dim=1)
    hi = torch.where(finite, flat, -torch.inf).amax(dim=1)
    degenerate = hi <= lo
    lo = torch.where(degenerate, lo - 0.5, lo)
    hi = torch.where(degenerate, hi + 0.5, hi)
    width = (hi - lo) / bins
    rng = torch.clamp(hi - lo, min=1e-30)
    idx = torch.floor((flat - lo[:, None]) / rng[:, None] * bins)
    idx = torch.where(finite, idx.clamp(0, bins - 1), float(bins)).long()
    offset = torch.arange(b, device=depth.device)[:, None] * (bins + 1)
    hist = torch.bincount((idx + offset).reshape(-1), minlength=b * (bins + 1))
    return hist.reshape(b, bins + 1)[:, :bins].float(), lo, width


def local_maxima(hist: torch.Tensor) -> torch.Tensor:
    """scipy `_local_maxima_1d` on (B, N): a plateau with strictly lower
    neighbours on both sides marks one peak at its midpoint."""
    b, n = hist.shape
    i = torch.arange(n, device=hist.device)
    jj = i[:, None]
    pair_ne = hist[:, None, :] != hist[:, :, None]  # [b, j, i]: hist[j] != hist[i]
    l_ne = torch.where(pair_ne & (jj < i[None, :]), jj, -1).amax(dim=1)
    r_ne = torch.where(pair_ne & (jj > i[None, :]), jj, n).amin(dim=1)
    l_val = torch.where(l_ne >= 0, hist.gather(1, l_ne.clamp(0, n - 1)), torch.inf)
    r_val = torch.where(r_ne <= n - 1, hist.gather(1, r_ne.clamp(0, n - 1)), torch.inf)
    plateau_peak = (l_ne >= 0) & (r_ne <= n - 1) & (l_val < hist) & (r_val < hist)
    midpoint = (l_ne + 1 + r_ne - 1) // 2
    is_peak = torch.zeros(b, n, dtype=torch.long, device=hist.device)
    is_peak.scatter_reduce_(1, torch.where(plateau_peak, midpoint, 0), plateau_peak.long(), reduce="amax")
    return is_peak.bool()


def peak_prominences(hist: torch.Tensor, is_peak: torch.Tensor) -> torch.Tensor:
    """scipy `peak_prominences` (wlen=None) for every index of (B, N); -inf off peaks."""
    n = hist.shape[1]
    i = torch.arange(n, device=hist.device)
    jj = i[:, None]
    higher = hist[:, None, :] < hist[:, :, None]  # [b, j, i]: hist[j] > hist[i]
    l_bound = torch.where(higher & (jj < i[None, :]), jj, -1).amax(dim=1)
    r_bound = torch.where(higher & (jj > i[None, :]), jj, n).amin(dim=1)
    col = hist[:, :, None]  # hist[j] along dim 1
    in_left = (jj > l_bound[:, None, :]) & (jj <= i[None, :])
    left_base = torch.where(in_left, col, torch.inf).amin(dim=1)
    in_right = (jj >= i[None, :]) & (jj < r_bound[:, None, :])
    right_base = torch.where(in_right, col, torch.inf).amin(dim=1)
    prom = hist - torch.maximum(left_base, right_base)
    return torch.where(is_peak, prom, -torch.inf)


def select_modes(hist, lo, width, num_modes: int = 3, prominence_frac: float = 0.01):
    """Top-`num_modes` peak centers by (height desc, center desc): (centers (B, T), valid (B, T))."""
    n = hist.shape[1]
    is_peak = local_maxima(hist)
    prom = peak_prominences(hist, is_peak)
    threshold = prominence_frac * hist.amax(dim=1, keepdim=True)
    selected = is_peak & (prom >= threshold)
    centers = lo[:, None] + (torch.arange(n, dtype=torch.float32, device=hist.device) + 0.5) * width[:, None]
    heights = torch.where(selected, hist, -torch.inf)
    order1 = torch.argsort(-centers, dim=1, stable=True)
    order2 = torch.argsort(-heights.gather(1, order1), dim=1, stable=True)
    top = order1.gather(1, order2)[:, :num_modes]
    return centers.gather(1, top), torch.isfinite(heights.gather(1, top))


def _windows(depth, centers, valid, ratio):
    """(B, T, H, W) bool: depth inside each valid peak's window."""
    half = centers * ratio[:, None] / 2.0
    lows = torch.clamp(centers - half, min=0.0)
    highs = centers + half
    d = depth[:, None]
    win = (d >= lows[:, :, None, None]) & (d <= highs[:, :, None, None])
    return win & valid[:, :, None, None]


def _slots(win, rem, valid):
    """The slot encoding: window i in slot i < K, remainder in slot K, inactive
    slots above K; K == 0 gives all-zero masks that are all active."""
    b, t = valid.shape
    k = valid.long().sum(dim=1)
    slots = torch.arange(t + 1, device=win.device)
    win_full = torch.cat([win, torch.zeros_like(win[:, :1])], dim=1)
    sl = slots[None, :, None, None]
    kk = k[:, None, None, None]
    masks = torch.where(sl < kk, win_full, (sl == kk) & rem[:, None])
    masks = masks & (kk != 0)
    active = torch.where(k[:, None] == 0, True, slots[None, :] <= k[:, None])
    return masks.float(), active.float()


def region_masks(depth, centers, valid, ratio):
    """(B, H, W) -> (masks (B, T+1, H, W) float32, active (B, T+1) float32)."""
    win = _windows(depth, centers, valid, ratio)
    return _slots(win, ~win.any(dim=1), valid)


def region_masks_pooled(depth, centers, valid, ratio, out_size):
    """`region_masks` max-pooled to `out_size` without the full-res masks;
    H % th == 0 and W % tw == 0. Returns masks (B, T+1, th, tw)."""
    b, h, w = depth.shape
    th, tw = out_size
    fh, fw = h // th, w // tw
    t = centers.shape[1]
    win = _windows(depth, centers, valid, ratio)
    anywin = win.any(dim=1)
    winp = win.reshape(b, t, th, fh, tw, fw).any(dim=5).any(dim=3)
    remp = ~anywin.reshape(b, th, fh, tw, fw).all(dim=4).all(dim=2)
    return _slots(winp, remp, valid)


def _modes(depth, num_modes, bins, prominence_frac):
    hist, lo, width = depth_histogram(depth, bins)
    return select_modes(hist, lo, width, num_modes, prominence_frac)


def dsam_region_masks_pooled(depth, ratio, out_size, num_modes=3, bins=512, prominence_frac=0.01):
    """(B, H, W) depth + (B,) ratio -> (masks (B, th, tw, T+1) channels-last, active (B, T+1))."""
    centers, valid = _modes(depth, num_modes, bins, prominence_frac)
    masks, active = region_masks_pooled(depth.float(), centers, valid, ratio.float(), out_size)
    return masks.permute(0, 2, 3, 1), active


def dsam_region_masks(depth, ratio, num_modes=3, bins=512, prominence_frac=0.01):
    """(B, H, W) depth + (B,) ratio -> (masks (B, T+1, H, W), active (B, T+1))."""
    centers, valid = _modes(depth, num_modes, bins, prominence_frac)
    return region_masks(depth.float(), centers, valid, ratio.float())


# --- Sobel gradient features (ops/sobel.py) ---


def _magnitude(gx: torch.Tensor, gy: torch.Tensor) -> torch.Tensor:
    """sqrt(gx^2 + gy^2) in gx's dtype, correctly rounded for float32 (see above)."""
    return torch.sqrt((gx * gx + gy * gy).to(torch.float64)).to(gx.dtype)


def _reflect101(n: int, device) -> torch.Tensor:
    """Indices of a length-n axis padded by one on each side, reflect-101."""
    return torch.cat([torch.tensor([1]), torch.arange(n), torch.tensor([n - 2])]).to(device)


def _conv1d(x: torch.Tensor, k: tuple[float, float, float], axis: int) -> torch.Tensor:
    """Correlate (..., H, W) along `axis` (-1 or -2) with a 3-tap kernel."""
    n = x.shape[axis]
    xp = x.index_select(axis, _reflect101(n, x.device))
    return k[0] * xp.narrow(axis, 0, n) + k[1] * xp.narrow(axis, 1, n) + k[2] * xp.narrow(axis, 2, n)


def sobel_xy(depth: torch.Tensor, dtype: torch.dtype = torch.float32) -> tuple[torch.Tensor, torch.Tensor]:
    """Sobel Gx, Gy of (..., H, W) depth in `dtype` (cv2 ksize=3)."""
    depth = depth.to(dtype)
    smooth, diff = (1.0, 2.0, 1.0), (-1.0, 0.0, 1.0)
    gx = _conv1d(_conv1d(depth, smooth, -2), diff, -1)
    gy = _conv1d(_conv1d(depth, diff, -2), smooth, -1)
    return gx, gy


def depth_gradient_magnitude(depth: torch.Tensor, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Raw (unnormalised) Sobel magnitude."""
    return _magnitude(*sobel_xy(depth, dtype))


def gradient_features(depth: torch.Tensor, invalid_depth_value: float = 0.0):
    """(normalised magnitude, grad x, grad y, validity mask), float32, each
    shaped like `depth`; the normalisation (mag - min_valid) / (max - min_valid)
    is per image over the last two axes."""
    depth = depth.to(torch.float32)
    valid = (depth != invalid_depth_value) & ~torch.isnan(depth)
    gx, gy = sobel_xy(depth)
    zero = torch.zeros((), dtype=torch.float32, device=depth.device)
    mag = torch.where(valid, _magnitude(gx, gy), zero)
    gx, gy = torch.where(valid, gx, zero), torch.where(valid, gy, zero)
    grad_valid = mag > 0

    flat = mag.flatten(-2)
    has_valid = grad_valid.flatten(-2).any(-1)[..., None, None]
    min_val = torch.where(grad_valid, mag, torch.inf).flatten(-2).amin(-1)[..., None, None]
    min_val = torch.where(has_valid, min_val, zero)
    max_val = flat.amax(-1)[..., None, None]
    denom = max_val - min_val
    normalized = torch.where(has_valid & (denom > 0), (mag - min_val) / denom.clamp(min=1e-30), zero)
    return normalized, gx, gy, grad_valid.to(torch.float32)


# --- sine position embedding (models/position.py) ---


def sine_position_embedding(h: int, w: int, num_pos_feats: int = 128, temperature: float = 10000.0,
                            device=None) -> torch.Tensor:
    """(H, W, 2 * num_pos_feats) channels-last [pos_y, pos_x], sin and cos interleaved."""
    eps = 1e-6
    scale = 2 * math.pi
    y = torch.arange(1, h + 1, dtype=torch.float32, device=device) / (h + eps) * scale
    x = torch.arange(1, w + 1, dtype=torch.float32, device=device) / (w + eps) * scale
    dim_t = torch.arange(num_pos_feats, dtype=torch.float32, device=device)
    dim_t = temperature ** (2 * torch.floor(dim_t / 2) / num_pos_feats)

    def table(p):
        p = p[:, None] / dim_t
        return torch.stack([p[:, 0::2].sin(), p[:, 1::2].cos()], dim=2).reshape(p.shape[0], -1)

    pos_y, pos_x = table(y), table(x)
    return torch.cat([pos_y[:, None, :].expand(h, w, -1), pos_x[None, :, :].expand(h, w, -1)], dim=-1)


# --- train-mode randomness (models/stochastic.py): the port's draws, in its order ---


def uniform(generator: torch.Generator, shape) -> torch.Tensor:
    """A draw in [0, 1) on the generator's device, as every random draw of the port's step."""
    return torch.rand(tuple(shape), generator=generator, device=generator.device)


def drop_path(x, rate: float, training: bool, generator):
    if not training or rate == 0.0:
        return x
    keep = 1.0 - rate
    mask = (uniform(generator, (x.shape[0],) + (1,) * (x.dim() - 1)) < keep).to(x.device)
    return x / keep * mask.to(x.dtype)


def dropout(x, p: float, training: bool, generator):
    if not training or p == 0.0:
        return x
    keep = 1.0 - p
    mask = (uniform(generator, x.shape) < keep).to(x.device)
    return torch.where(mask, x / keep, torch.zeros_like(x))


# --- deformable sampling (ops/kernels/deformable.py's plain versions) ---

_CORNERS = ((0, 0), (0, 1), (1, 0), (1, 1))  # (dy, dx)
_OFFSETS = (-1, 0, 1, 2)  # cells from floor(g) where 1 - |g - i| can be >= 0 in f32


def deform_sample_level(gx, gy, aw, v, h: int, w: int) -> torch.Tensor:
    """One level: an explicit 4-corner gather, float32 sums. gx, gy, aw (BH, L, P)
    with gx, gy in pixel units; v (BH, h*w, hd). Returns (BH, L, hd)."""
    bh, l, npts = gx.shape
    hd = v.shape[-1]
    x0, y0 = torch.floor(gx), torch.floor(gy)
    fx, fy = gx - x0, gy - y0
    out = torch.zeros(bh, l, hd, dtype=torch.float32, device=gx.device)
    for dy, dx in _CORNERS:
        xi, yi = x0 + dx, y0 + dy
        valid = (xi >= 0) & (xi <= w - 1) & (yi >= 0) & (yi <= h - 1)
        wgt = aw * (fy if dy else 1 - fy) * (fx if dx else 1 - fx) * valid
        idx = (yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)).long().reshape(bh, l * npts, 1)
        corner = torch.gather(v, 1, idx.expand(bh, l * npts, hd)).reshape(bh, l, npts, hd)
        out += torch.einsum("blp,blpd->bld", _q(wgt), _q(corner))
    return out


def _tent_factors(g):
    """Per offset from floor(g): the tent values max(0, 1 - |g - i|) and their
    slopes in g as JAX differentiates them (half slopes where 1 - |g - i| = 0)."""
    g0 = torch.floor(g)
    values, slopes = [], []
    for o in _OFFSETS:
        u = g - (g0 + o)
        t = 1.0 - u.abs()
        sign = torch.where(u >= 0, -1.0, 1.0)
        values.append(t.clamp(min=0.0))
        slopes.append(torch.where(t > 0, sign, torch.where(t == 0, 0.5 * sign, 0.0)))
    return g0, values, slopes


def deform_sample_level_bwd(gx, gy, aw, v, h: int, w: int, grad_out):
    """The gradient of `deform_sample_level` with the JAX package's tent
    subgradient at integer coordinates: (d gx, d gy, d aw, d v)."""
    bh, l, npts = gx.shape
    hd = v.shape[-1]
    x0, wx, dx = _tent_factors(gx)
    y0, wy, dy = _tent_factors(gy)
    d_gx, d_gy, d_aw = torch.zeros_like(gx), torch.zeros_like(gy), torch.zeros_like(aw)
    d_v = torch.zeros(bh * h * w, hd, dtype=torch.float32, device=v.device)
    base = (torch.arange(bh, device=v.device) * (h * w)).reshape(bh, 1, 1)
    for iy, oy in enumerate(_OFFSETS):
        yi = y0 + oy
        for ix, ox in enumerate(_OFFSETS):
            xi = x0 + ox
            valid = ((xi >= 0) & (xi <= w - 1) & (yi >= 0) & (yi <= h - 1)).float()
            cw, cgx, cgy = wy[iy] * wx[ix] * valid, wy[iy] * dx[ix] * valid, dy[iy] * wx[ix] * valid
            idx = (yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)).long()
            corner = torch.gather(v, 1, idx.reshape(bh, l * npts, 1).expand(bh, l * npts, hd))
            dot = torch.einsum("blpd,bld->blp", _q(corner.reshape(bh, l, npts, hd)), _q(grad_out))
            d_aw += cw * dot
            d_gx += cgx * dot
            d_gy += cgy * dot
            contrib = (aw * cw)[..., None] * grad_out[:, :, None, :]
            d_v.index_add_(0, (idx + base).reshape(-1), contrib.reshape(-1, hd))
    return aw * d_gx, aw * d_gy, d_aw, d_v.reshape(bh, h * w, hd)


def _per_level(value, spatial_shapes, locations, weights):
    """Per level: (gx, gy, aw, v, h, w, start) in the one-level layouts."""
    b, l, nh, nl, npts, _ = locations.shape
    hd = value.shape[-1]
    start = 0
    for lvl, (h, w) in enumerate(spatial_shapes):
        v = value[:, start : start + h * w].permute(0, 2, 1, 3).reshape(b * nh, h * w, hd)
        coords = locations[:, :, :, lvl].permute(0, 2, 1, 3, 4).reshape(b * nh, l, npts, 2)
        aw = weights[:, :, :, lvl].permute(0, 2, 1, 3).reshape(b * nh, l, npts)
        yield coords[..., 0] * w - 0.5, coords[..., 1] * h - 0.5, aw, v, h, w, start
        start += h * w


class DeformSample(torch.autograd.Function):
    """All levels summed, with the tent gradient. value (B, L_total, nh, hd),
    locations (B, L, nh, nl, P, 2) normalised (x, y), weights (B, L, nh, nl, P);
    returns (B, L, nh * hd)."""

    @staticmethod
    def forward(ctx, value, locations, weights, spatial_shapes):
        ctx.spatial_shapes = spatial_shapes
        ctx.save_for_backward(value, locations, weights)
        b, l, nh = locations.shape[:3]
        hd = value.shape[-1]
        out = torch.zeros(b * nh, l, hd, dtype=torch.float32, device=value.device)
        for gx, gy, aw, v, h, w, _ in _per_level(value, spatial_shapes, locations, weights):
            out += deform_sample_level(gx, gy, aw, v, h, w)
        return out.reshape(b, nh, l, hd).permute(0, 2, 1, 3).reshape(b, l, nh * hd)

    @staticmethod
    def backward(ctx, grad_out):
        value, locations, weights = ctx.saved_tensors
        b, l, nh, nl, npts, _ = locations.shape
        hd = value.shape[-1]
        g = grad_out.reshape(b, l, nh, hd).permute(0, 2, 1, 3).reshape(b * nh, l, hd)
        d_value = torch.zeros_like(value)
        d_loc, d_w = [], []
        for gx, gy, aw, v, h, w, start in _per_level(value, ctx.spatial_shapes, locations, weights):
            d_gx, d_gy, d_aw, d_v = deform_sample_level_bwd(gx, gy, aw, v, h, w, g)
            d_value[:, start : start + h * w] = d_v.reshape(b, nh, h * w, hd).permute(0, 2, 1, 3)
            d_loc.append(torch.stack([d_gx * w, d_gy * h], dim=-1).reshape(b, nh, l, npts, 2).permute(0, 2, 1, 3, 4))
            d_w.append(d_aw.reshape(b, nh, l, npts).permute(0, 2, 1, 3))
        return d_value, torch.stack(d_loc, dim=3), torch.stack(d_w, dim=3), None


def deform_sample(value, spatial_shapes, locations, weights) -> torch.Tensor:
    return DeformSample.apply(value, locations, weights, tuple(map(tuple, spatial_shapes)))


# --- masked cross-attention (ops/kernels/masked_attention.py's plain version) ---

NEG_INF = -1e9


def masked_cross_attention(q, k, v, mask_logits, all_blocked) -> torch.Tensor:
    """q (B, H, Q, hd) pre-scaled; k, v (B, H, K, hd); mask_logits (B, Q, K); a
    key is blocked where its logit is < 0, unless the query blocks all keys."""
    blocked = (mask_logits < 0.0) & ~all_blocked[:, :, None]
    bias = torch.where(blocked[:, None], NEG_INF, 0.0)
    attn = torch.softmax(_q(q) @ _q(k).transpose(-1, -2) + bias, dim=-1)
    return _q(attn) @ _q(v)


# --- point sampling (ops/kernels/point_sample.py's plain version) ---


def point_sample(masks: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """masks (B, N, H, W), coords (B, N, P, 2) (x, y) in [0, 1], one set per mask -> (B, N, P)."""
    b, n, h, w = masks.shape
    npts = coords.shape[2]
    grid = (2.0 * coords.detach().to(masks.device, masks.dtype) - 1.0).reshape(b * n, 1, npts, 2)
    out = F.grid_sample(masks.reshape(b * n, 1, h, w), grid, mode="bilinear", padding_mode="zeros",
                        align_corners=False)
    return out.reshape(b, n, npts)
