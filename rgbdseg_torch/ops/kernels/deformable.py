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
the bytes and the design). Its backward (`csrc/deformable_bwd.cu`) is a kernel
too, one call per encoder layer as well: a pair kernel computes d locations
and d weights (per level, each (query, head) pair lists its cells of non-zero
tent value or slope in shared memory, then loads their V rows 8 at a time); d
value is summed in destination order, without float atomics: the pair kernel
also writes each query's points' coordinates and weights in compact records,
a mark kernel sets, in a bitmap per tile of each level's map, the queries
with a point's value corner in it (`tile_lists_plain` is the marked queries'
plain version), and a gather kernel adds each tile's queries' contributions
in ascending order (`tile_plan` gives each level's tiles 1 to 8 warps), on
the tensor cores, reading each query's grad_out row once per tile, and
writes each cell once, in V's dtype, with the same bits on every run.

The gradient is the JAX package's: there the backward is the VJP of the tent
twin `tent_sample_level_xla`, which differentiates t_i = max(0, 1 - |g - i|)
cell by cell in float32. Away from integers that is the bilinear gradient. But
where 1 - |g - i| is exactly 0, JAX's `max` splits the gradient in halves, and
`jax.grad(abs)(0) = 1`: at an exactly integer g (where the seeded model puts
most level-0 samples) the slopes at cells g - 1, g, g + 1 are -1/2, -1, +1/2,
not the floor-based -1, +1 that torch's autograd of the plain forward gives,
and f32 rounding produces the same half slope within an ulp of an integer
(g = -3e-8 rounds 1 - |g - 1| to 0). So the plain backward
(`deform_sample_level_plain_bwd`) is written out as that tent arithmetic, over
the cells floor(g) - 1 .. floor(g) + 2, and the kernel repeats it.

`deform_sample_levels(value, spatial_shapes, locations, weights)` takes the
layouts the model produces: value (B, L_total, nh, hd) float32 or bfloat16,
the levels stacked in order; locations (B, L, nh, nl, P, 2) float32 normalised
(x, y); weights (B, L, nh, nl, P). Returns (B, L, nh * hd) float32.

`deform_sample_level(gx, gy, aw, v, h, w)` keeps the JAX per-level signature:
gx, gy, aw (BH, L, P) float32, gx/gy in pixel units (x * w - 0.5); v (BH, h*w,
hd) float32 or bfloat16; returns (BH, L, hd) float32. On the card it is a
one-level call of the same kernels, forward and backward.

Both wrappers are `torch.autograd.Function`s: gradients reach the value, the
locations (or gx, gy) and the weights.
"""

from __future__ import annotations

import ctypes

import torch

from ...utils.trace import span
from . import check_cuda_tensor, launch

_CORNERS = ((0, 0), (0, 1), (1, 0), (1, 1))  # (dy, dx)
_OFFSETS = (-1, 0, 1, 2)  # cells from floor(g) where 1 - |g - i| can be >= 0 in f32


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


def _tent_factors(g):
    """Per offset in `_OFFSETS` from floor(g): the tent values max(0, 1 - |g - i|)
    and their slopes in g as JAX differentiates them (see the module docstring)."""
    g0 = torch.floor(g)
    values, slopes = [], []
    for o in _OFFSETS:
        u = g - (g0 + o)
        t = 1.0 - u.abs()
        sign = torch.where(u >= 0, -1.0, 1.0)  # d(1 - |u|)/du, with d|u|/du = 1 at u = 0
        values.append(t.clamp(min=0.0))
        slopes.append(torch.where(t > 0, sign, torch.where(t == 0, 0.5 * sign, 0.0)))
    return g0, values, slopes


def deform_sample_level_plain_bwd(gx, gy, aw, v, h: int, w: int, grad_out):
    """Plain PyTorch gradient of `deform_sample_level_plain` with JAX's tent
    subgradient at integer coordinates: (d gx, d gy, d aw, d v) for grad_out
    (BH, L, hd). float32 throughout; d v comes back in v's dtype."""
    bh, l, npts = gx.shape
    hd = v.shape[-1]
    gx, gy, aw = gx.float(), gy.float(), aw.float()
    vf = v.float()
    grad_out = grad_out.float()
    x0, wx, dx = _tent_factors(gx)
    y0, wy, dy = _tent_factors(gy)
    d_gx = torch.zeros_like(gx)
    d_gy = torch.zeros_like(gy)
    d_aw = torch.zeros_like(aw)
    d_v = torch.zeros(bh * h * w, hd, dtype=torch.float32, device=v.device)
    base = (torch.arange(bh, device=v.device) * (h * w)).reshape(bh, 1, 1)
    for iy, oy in enumerate(_OFFSETS):
        yi = y0 + oy
        for ix, ox in enumerate(_OFFSETS):
            xi = x0 + ox
            valid = ((xi >= 0) & (xi <= w - 1) & (yi >= 0) & (yi <= h - 1)).float()
            cw = wy[iy] * wx[ix] * valid
            cgx = wy[iy] * dx[ix] * valid
            cgy = dy[iy] * wx[ix] * valid
            idx = (yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)).long()
            corner = torch.gather(vf, 1, idx.reshape(bh, l * npts, 1).expand(bh, l * npts, hd))
            dot = torch.einsum("blpd,bld->blp", corner.reshape(bh, l, npts, hd), grad_out)
            d_aw += cw * dot
            d_gx += cgx * dot
            d_gy += cgy * dot
            contrib = (aw * cw)[..., None] * grad_out[:, :, None, :]
            d_v.index_add_(0, (idx + base).reshape(-1), contrib.reshape(-1, hd))
    return aw * d_gx, aw * d_gy, d_aw, d_v.reshape(bh, h * w, hd).to(v.dtype)


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


def deform_sample_levels_plain_bwd(value, spatial_shapes, locations, weights, grad_out):
    """Plain PyTorch gradient of `deform_sample_levels_plain` (the per-level
    plain gradient, mapped back through the layouts and x * w - 0.5): d value
    (in value's dtype), d locations, d weights (float32) for grad_out (B, L, nh * hd)."""
    b, l, nh, nl, npts, _ = locations.shape
    hd = value.shape[-1]
    g = grad_out.float().reshape(b, l, nh, hd).permute(0, 2, 1, 3).reshape(b * nh, l, hd)
    d_value, d_loc, d_w = [], [], []
    start = 0
    for lvl, (h, w) in enumerate(spatial_shapes):
        v = value[:, start : start + h * w].permute(0, 2, 1, 3).reshape(b * nh, h * w, hd)
        coords = locations[:, :, :, lvl].float().permute(0, 2, 1, 3, 4).reshape(b * nh, l, npts, 2)
        aw = weights[:, :, :, lvl].permute(0, 2, 1, 3).reshape(b * nh, l, npts)
        d_gx, d_gy, d_aw, d_v = deform_sample_level_plain_bwd(
            coords[..., 0] * w - 0.5, coords[..., 1] * h - 0.5, aw, v, h, w, g)
        d_value.append(d_v.reshape(b, nh, h * w, hd).permute(0, 2, 1, 3))
        d_loc.append(torch.stack([d_gx * w, d_gy * h], dim=-1).reshape(b, nh, l, npts, 2).permute(0, 2, 1, 3, 4))
        d_w.append(d_aw.reshape(b, nh, l, npts).permute(0, 2, 1, 3))
        start += h * w
    d_value = torch.cat(d_value, dim=1)
    if d_value.shape[1] < value.shape[1]:  # rows past the last level get no gradient
        d_value = torch.cat([d_value, d_value.new_zeros(b, value.shape[1] - start, nh, hd)], dim=1)
    return d_value, torch.stack(d_loc, dim=3), torch.stack(d_w, dim=3)


def _check_launch(value, locations, weights, spatial_shapes, starts):
    """Shapes, dtypes and layouts the K1 kernels take; returns (B, L, nh, nl, P, hd, L_total)."""
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
    return b, l, nh, nl, npts, hd, ltot


def _level_table(spatial_shapes, starts, tiles=None):
    """(h, w, start) per level for the forward; with `tiles`, (h, w, start, tile
    rows, tile columns, gather warps per tile) for the backward."""
    rows = [(h, w, s) if tiles is None else (h, w, s, *tiles[i])
            for i, (s, (h, w)) in enumerate(zip(starts, spatial_shapes))]
    return (ctypes.c_int * sum(map(len, rows)))(*(x for r in rows for x in r))


# The backward's d-value tiles (csrc/deformable_bwd.cu): every level is cut
# into tiles of TILE cells (rows, columns); a gather block has 8 warps, and a
# level's tiles get 1, 2, 4 or 8 of them each, so that a warp's part of a
# tile's list is about WARP_QUERIES queries.
TILE = (4, 8)
WARP_QUERIES = 64


def tile_plan(spatial_shapes, nq: int) -> list[tuple[int, int, int]]:
    """The backward's d-value tiles, (rows, columns, gather warps per tile) per
    level. A tile lists the queries with a point's value corner in it; where
    `nq` queries' points spread evenly over the level and a query's points
    reach about twice a tile's cells (as at the in-model geometry), a tile
    lists nq * min(1, 2 * cells / (h * w)) queries, and gets the largest power
    of two up to 8 of warps that leaves each at least WARP_QUERIES of them."""
    th, tw = TILE
    plan = []
    for h, w in spatial_shapes:
        listed = nq * min(1.0, 2 * th * tw / (h * w))
        wpt = 1
        while wpt < 8 and listed >= 2 * wpt * WARP_QUERIES:
            wpt *= 2
        plan.append((th, tw, wpt))
    return plan


def scratch_layout(spatial_shapes, segments: int, nq: int) -> tuple[int, int]:
    """The backward's int32 scratch, as the kernels lay it out: (words per
    bitmap, total 32-bit words). First the bitmaps: per (b, head), `segments`
    of them, and per tile over all levels in order, a bitmap over the queries
    (bit q % 32 of word q // 32: one of query q's points at the tile's level
    has a value corner in it), rounded up to a multiple of 4 words; then the
    records, float32: per segment, level and query its 4 points' (x, y), and
    after all of those their weights."""
    th, tw = TILE
    words = -(-nq // 32)
    ntiles = sum(-(-h // th) * -(-w // tw) for h, w in spatial_shapes)
    return words, -(-segments * ntiles * words // 4) * 4 + segments * len(spatial_shapes) * nq * 12


def tile_lists_plain(gx, gy, h: int, w: int) -> list[torch.Tensor]:
    """Plain version of the backward's bucketing for one (b, head, level): gx,
    gy (nq, P) the points' pixel coordinates. Per tile of TILE cells, in raster
    order, the queries with a point's value corner (a cell of non-zero tent
    value on the map) in it, ascending, each once."""
    th, tw = TILE
    ntx = -(-w // tw)
    nq = gx.shape[0]
    x0, wx, _ = _tent_factors(gx.float())
    y0, wy, _ = _tent_factors(gy.float())
    member = torch.zeros(-(-h // th) * ntx, nq, dtype=torch.bool, device=gx.device)
    queries = torch.arange(nq, device=gx.device)[:, None].expand(gx.shape)
    for dy in (0, 1):
        for dx in (0, 1):
            yy, xx = y0 + dy, x0 + dx
            on = (xx >= 0) & (xx <= w - 1) & (yy >= 0) & (yy <= h - 1) & (wy[1 + dy] * wx[1 + dx] != 0)
            tiles = yy.clamp(0, h - 1).long() // th * ntx + xx.clamp(0, w - 1).long() // tw
            member[tiles[on], queries[on]] = True
    return [torch.nonzero(m).squeeze(1) for m in member]


def _launch(value, locations, weights, spatial_shapes, starts, normalized: bool) -> torch.Tensor:
    """One K1 launch over value (B, L_total, nh, hd), locations (B, L, nh, nl, P, 2), weights (B, L, nh, nl, P)."""
    b, l, nh, nl, npts, hd, ltot = _check_launch(value, locations, weights, spatial_shapes, starts)
    out = torch.empty(b, l, nh * hd, dtype=torch.float32, device=value.device)
    launch(
        "deformable",
        value.data_ptr(), locations.data_ptr(), weights.data_ptr(), out.data_ptr(),
        _level_table(spatial_shapes, starts),
        b, l, nh, nl, npts, hd, ltot, int(normalized), int(value.dtype == torch.bfloat16),
        flops=8 * b * l * nh * nl * npts * hd,  # 4 corners, a multiply and an add per channel
    )
    return out


def _launch_bwd(value, locations, weights, spatial_shapes, starts, normalized: bool, grad_out):
    """One K1 backward call; returns (d value in value's dtype, d locations, d weights float32)."""
    return _launch_bwd_impl(value, locations, weights, spatial_shapes, starts, normalized, grad_out)[:3]


def _launch_bwd_impl(value, locations, weights, spatial_shapes, starts, normalized: bool, grad_out):
    """`_launch_bwd`, and the bucketing's int32 scratch after the call (the
    tiles' bitmaps, laid out as `scratch_layout` says)."""
    b, l, nh, nl, npts, hd, ltot = _check_launch(value, locations, weights, spatial_shapes, starts)
    grad_out = grad_out.float().contiguous()
    if grad_out.shape != (b, l, nh * hd):
        raise ValueError(f"grad_out has shape {tuple(grad_out.shape)}; expected ({b}, {l}, {nh * hd})")
    if list(starts) != _level_starts(spatial_shapes):
        raise ValueError(f"level starts {list(starts)}: the backward takes the levels in consecutive rows from 0")
    d_loc = torch.empty_like(locations)
    d_w = torch.empty_like(weights)
    total = scratch_layout(spatial_shapes, b * nh, l)[-1]
    scratch = torch.empty(total, dtype=torch.int32, device=value.device)  # the kernels clear it
    if b * l * nh == 0:
        return torch.zeros_like(value), d_loc, d_w, scratch
    d_value = torch.empty_like(value)  # the kernels write every row of the levels, in value's dtype
    end = starts[-1] + spatial_shapes[-1][0] * spatial_shapes[-1][1]
    if end < ltot:
        d_value[:, end:].zero_()  # rows past the last level get no gradient
    launch(
        "deformable_bwd",
        value.data_ptr(), locations.data_ptr(), weights.data_ptr(), grad_out.data_ptr(),
        d_value.data_ptr(), d_loc.data_ptr(), d_w.data_ptr(), scratch.data_ptr(), total,
        _level_table(spatial_shapes, starts, tile_plan(spatial_shapes, l)),
        b, l, nh, nl, npts, hd, ltot, int(normalized), int(value.dtype == torch.bfloat16),
        flops=16 * b * l * nh * nl * npts * hd,  # per corner: the product with grad_out, the d value update
    )
    return d_value, d_loc, d_w, scratch


def _level_starts(spatial_shapes):
    starts, s = [], 0
    for h, w in spatial_shapes:
        starts.append(s)
        s += h * w
    return starts


class DeformSampleLevels(torch.autograd.Function):
    """`deform_sample_levels` with its gradient: the K1 kernels on the card, the
    plain versions on the CPU."""

    @staticmethod
    def forward(ctx, value, locations, weights, spatial_shapes):
        ctx.spatial_shapes = spatial_shapes
        ctx.save_for_backward(value, locations, weights)
        if not value.is_cuda:
            return deform_sample_levels_plain(value, spatial_shapes, locations, weights)
        return _launch(value, locations, weights, spatial_shapes, _level_starts(spatial_shapes), normalized=True)

    @staticmethod
    @span("op.k1_bwd")
    def backward(ctx, grad_out):
        value, locations, weights = ctx.saved_tensors
        shapes = ctx.spatial_shapes
        if not value.is_cuda:
            d_value, d_loc, d_w = deform_sample_levels_plain_bwd(value, shapes, locations, weights, grad_out)
        else:
            d_value, d_loc, d_w = _launch_bwd(value, locations, weights, shapes, _level_starts(shapes), True, grad_out)
        return d_value, d_loc.to(locations.dtype), d_w.to(weights.dtype), None


class DeformSampleLevel(torch.autograd.Function):
    """`deform_sample_level` with its gradient: a one-level call of the K1
    kernels on the card, the plain versions on the CPU."""

    @staticmethod
    def forward(ctx, gx, gy, aw, v, h, w):
        ctx.hw = (h, w)
        ctx.save_for_backward(gx, gy, aw, v)
        if not gx.is_cuda:
            return deform_sample_level_plain(gx, gy, aw, v, h, w)
        value, loc, aw6 = _one_level(gx, gy, aw, v, h, w)
        return _launch(value, loc, aw6, [(h, w)], [0], normalized=False).reshape(gx.shape[0], gx.shape[1], -1)

    @staticmethod
    @span("op.k1_bwd")
    def backward(ctx, grad_out):
        gx, gy, aw, v = ctx.saved_tensors
        h, w = ctx.hw
        if not gx.is_cuda:
            d_gx, d_gy, d_aw, d_v = deform_sample_level_plain_bwd(gx, gy, aw, v, h, w, grad_out)
            return d_gx, d_gy, d_aw, d_v, None, None
        value, loc, aw6 = _one_level(gx, gy, aw, v, h, w)
        d_value, d_loc, d_w = _launch_bwd(value, loc, aw6, [(h, w)], [0], False, grad_out)
        return (d_loc[..., 0].reshape(gx.shape), d_loc[..., 1].reshape(gy.shape), d_w.reshape(aw.shape),
                d_value.reshape(v.shape), None, None)


def _one_level(gx, gy, aw, v, h, w):
    """The per-level inputs in the multi-level kernels' layouts (one level, one head)."""
    bh, l, npts = gx.shape
    if gy.shape != gx.shape or aw.shape != gx.shape:
        raise ValueError(f"gx {tuple(gx.shape)}, gy {tuple(gy.shape)}, aw {tuple(aw.shape)} must match")
    if v.dim() != 3 or v.shape[0] != bh or v.shape[1] != h * w:
        raise ValueError(f"v has shape {tuple(v.shape)}; expected ({bh}, {h * w}, hd)")
    loc = torch.stack([gx, gy], dim=-1).reshape(bh, l, 1, 1, npts, 2)
    return v.unsqueeze(2), loc, aw.contiguous().reshape(bh, l, 1, 1, npts)


@span("op.k1")
def deform_sample_levels(value, spatial_shapes, locations, weights) -> torch.Tensor:
    """K1 wrapper: the plain versions for CPU tensors, one CUDA launch (forward
    and backward each) for CUDA ones."""
    return DeformSampleLevels.apply(value, locations, weights, tuple(map(tuple, spatial_shapes)))


@span("op.k1")
def deform_sample_level(gx, gy, aw, v, h: int, w: int) -> torch.Tensor:
    """K1 for one level: the plain versions for CPU tensors, a one-level CUDA
    launch (forward and backward each) for CUDA ones."""
    return DeformSampleLevel.apply(gx, gy, aw, v, h, w)
