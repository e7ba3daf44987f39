"""DSAM depth decomposition, batched and on the device
(counterpart of `rgbdseg_tpu/ops/depth_decomp.py`).

The reference decomposes each depth map into T+1 region masks:
  1. a `bins`-bin histogram over [nanmin, nanmax] (np.histogram semantics:
     NaNs dropped, a degenerate range widened to +-0.5);
  2. scipy.signal.find_peaks with prominence >= frac * max(hist) (plateaus
     mark their midpoint; border plateaus are no peaks);
  3. the top-T peaks by (height desc, center desc); windows center +- center*ratio/2;
  4. window masks plus a remainder mask, in the fixed-shape slot encoding of
     `region_masks`.
Every function works on a batch: depth (B, H, W), ratio (B,). The histogram is
a plain count (`bincount`); peaks and prominences are O(bins²) masked reductions.
"""

from __future__ import annotations

import torch


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
