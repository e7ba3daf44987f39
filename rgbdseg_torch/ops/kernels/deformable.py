"""Multi-scale deformable-attention sampling (kernel K1).

    out[b, l, h, :] = sum_lvl sum_p weights[b, l, h, lvl, p]
                        * bilinear_zeros(V_lvl[b, :, :, h, :], locations[b, l, h, lvl, p])

Replaces `rgbdseg_tpu/ops/kernels/deformable.py::tent_sample_level`
(`_tent_kernel`) and `::tent_sample_level_band` (`_tent_band_kernel`), which
compute one level of this sum as a dense tent matrix times V on the TPU's
matrix unit, and the level loop around them in the JAX pixel decoder. The CUDA
kernel (`rgbdseg_torch/csrc/deformable.cu`) gathers the 4 bilinear corners
directly, for all levels in one launch, hd / 4 lanes per (query, head) with a
float4 of channels each. It is bound by memory on the H100 (see the source for
the bytes and the design).

`deform_sample_levels(value, spatial_shapes, locations, weights)` takes the
layouts the model produces: value (B, L_total, nh, hd) float32 or bfloat16,
the levels stacked in order; locations (B, L, nh, nl, P, 2) float32 normalised
(x, y); weights (B, L, nh, nl, P). Returns (B, L, nh * hd) float32.

`deform_sample_level(gx, gy, aw, v, h, w)` keeps the JAX per-level signature:
gx, gy, aw (BH, L, P) float32, gx/gy in pixel units (x * w - 0.5); v (BH, h*w,
hd) float32 or bfloat16; returns (BH, L, hd) float32. On the card it is a
one-level call of the same kernel. Forward only.
"""

from __future__ import annotations

import ctypes

import torch

from . import check_cuda_tensor, launch

_CORNERS = ((0, 0), (0, 1), (1, 0), (1, 1))  # (dy, dx)


def deform_sample_level_plain(gx, gy, aw, v, h: int, w: int) -> torch.Tensor:
    """Plain PyTorch version of one level: an explicit 4-corner gather, float32 accumulation."""
    bh, l, npts = gx.shape
    hd = v.shape[-1]
    gx = gx.float()
    gy = gy.float()
    aw = aw.float()
    vf = v.float()
    x0 = torch.floor(gx)
    y0 = torch.floor(gy)
    fx = gx - x0
    fy = gy - y0
    out = torch.zeros(bh, l, hd, dtype=torch.float32, device=gx.device)
    for dy, dx in _CORNERS:
        xi = x0 + dx
        yi = y0 + dy
        valid = (xi >= 0) & (xi <= w - 1) & (yi >= 0) & (yi <= h - 1)
        wgt = aw * (fy if dy else 1 - fy) * (fx if dx else 1 - fx) * valid
        idx = (yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)).long().reshape(bh, l * npts, 1)
        corner = torch.gather(vf, 1, idx.expand(bh, l * npts, hd)).reshape(bh, l, npts, hd)
        out += torch.einsum("blp,blpd->bld", wgt, corner)
    return out


def deform_sample_levels_plain(value, spatial_shapes, locations, weights) -> torch.Tensor:
    """Plain PyTorch version of all levels: the per-level gather, summed over levels."""
    b, l, nh, nl, npts, _ = locations.shape
    hd = value.shape[-1]
    out = torch.zeros(b * nh, l, hd, dtype=torch.float32, device=value.device)
    start = 0
    for lvl, (h, w) in enumerate(spatial_shapes):
        v = value[:, start : start + h * w].permute(0, 2, 1, 3).reshape(b * nh, h * w, hd)
        coords = locations[:, :, :, lvl].float().permute(0, 2, 1, 3, 4).reshape(b * nh, l, npts, 2)
        aw = weights[:, :, :, lvl].permute(0, 2, 1, 3).reshape(b * nh, l, npts)
        out += deform_sample_level_plain(coords[..., 0] * w - 0.5, coords[..., 1] * h - 0.5, aw, v, h, w)
        start += h * w
    return out.reshape(b, nh, l, hd).permute(0, 2, 1, 3).reshape(b, l, nh * hd)


def _launch(value, locations, weights, spatial_shapes, starts, normalized: bool) -> torch.Tensor:
    """One K1 launch over value (B, L_total, nh, hd), locations (B, L, nh, nl, P, 2), weights (B, L, nh, nl, P)."""
    b, l, nh, nl, npts, two = locations.shape
    hd = value.shape[-1]
    if two != 2 or weights.shape != (b, l, nh, nl, npts):
        raise ValueError(f"locations {tuple(locations.shape)} / weights {tuple(weights.shape)} must be "
                         f"(B, L, nh, nl, P, 2) / (B, L, nh, nl, P)")
    if len(spatial_shapes) != nl or nl not in (1, 3):
        raise ValueError(f"{len(spatial_shapes)} spatial shapes for {nl} levels; the kernel takes 1 or 3")
    ltot = value.shape[1]
    if value.dim() != 4 or value.shape[0] != b or value.shape[2] != nh:
        raise ValueError(f"value has shape {tuple(value.shape)}; expected ({b}, L_total, {nh}, hd)")
    if max(s + h * w for s, (h, w) in zip(starts, spatial_shapes)) > ltot:
        raise ValueError(f"levels {list(spatial_shapes)} do not fit in L_total={ltot}")
    if npts != 4 or hd not in (16, 32):
        raise ValueError(f"the kernel takes P=4 and hd in (16, 32), not P={npts}, hd={hd}")
    check_cuda_tensor(locations, "locations", (torch.float32,))
    check_cuda_tensor(weights, "weights", (torch.float32,))
    check_cuda_tensor(value, "value", (torch.float32, torch.bfloat16))
    table = (ctypes.c_int * (3 * nl))(*(x for s, (h, w) in zip(starts, spatial_shapes) for x in (h, w, s)))
    out = torch.empty(b, l, nh * hd, dtype=torch.float32, device=value.device)
    launch(
        "deformable",
        value.data_ptr(), locations.data_ptr(), weights.data_ptr(), out.data_ptr(), table,
        b, l, nh, nl, npts, hd, ltot, int(normalized), int(value.dtype == torch.bfloat16),
    )
    return out


def deform_sample_levels(value, spatial_shapes, locations, weights) -> torch.Tensor:
    """K1 wrapper: the plain version for CPU tensors, one CUDA launch for CUDA ones."""
    if not value.is_cuda:
        return deform_sample_levels_plain(value, spatial_shapes, locations, weights)
    starts, s = [], 0
    for h, w in spatial_shapes:
        starts.append(s)
        s += h * w
    return _launch(value, locations, weights, spatial_shapes, starts, normalized=True)


def deform_sample_level(gx, gy, aw, v, h: int, w: int) -> torch.Tensor:
    """K1 for one level: the plain version for CPU tensors, a one-level CUDA launch for CUDA ones."""
    if not gx.is_cuda:
        return deform_sample_level_plain(gx, gy, aw, v, h, w)
    bh, l, npts = gx.shape
    if gy.shape != gx.shape or aw.shape != gx.shape:
        raise ValueError(f"gx {tuple(gx.shape)}, gy {tuple(gy.shape)}, aw {tuple(aw.shape)} must match")
    if v.dim() != 3 or v.shape[0] != bh or v.shape[1] != h * w:
        raise ValueError(f"v has shape {tuple(v.shape)}; expected ({bh}, {h * w}, hd)")
    loc = torch.stack([gx, gy], dim=-1).reshape(bh, l, 1, 1, npts, 2)
    return _launch(v.unsqueeze(2), loc, aw.reshape(bh, l, 1, 1, npts), [(h, w)], [0], normalized=False)
