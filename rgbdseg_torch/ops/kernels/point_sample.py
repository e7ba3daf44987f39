"""Bilinear sampling of each mask at its own points (the criterion's point
sampling), with a deterministic gradient to the masks.

    out[b, n, p] = bilinear_zeros(masks[b, n], coords[b, n, p])

Not the counterpart of a TPU kernel: the JAX package computes this function in
XLA, outside any Pallas call (`rgbdseg_tpu/ops/losses.py:72`
`_sample_each_mask`, a custom VJP whose backward is one tent-table matmul per
layer, so its training repeats bit for bit). It is a hand kernel because no
library call has a deterministic backward for it: aten's
`grid_sampler_2d_backward` on CUDA adds with float atomics (and raises under
`torch.use_deterministic_algorithms(True)`). The CUDA source
(`rgbdseg_torch/csrc/point_sample.cu`) samples as aten's `F.grid_sample` does
(forward: aten's arithmetic and corner order, 4 points a thread), and sums
the gradient without float atomics in one launch: each point is keyed by its
footprint's top-left cell on the (H+1) x (W+1) lattice; a block per band of
mask rows keeps, in shared memory, the points that touch its band, lists each
lattice cell's points in ascending order, and one thread per mask cell adds
the <= 4 lists that touch it in a fixed order and writes its cell once, so
two launches give the same bits. `point_sample_bwd_ordered_plain` is that
sum emulated exactly, on any device. The forward and the backward count their
launches apart (`point_sample`, `point_sample_bwd`).

`point_sample(masks, coords)`: masks (B, N, H, W) float32, coords (B, N, P, 2)
(x, y) in [0, 1], one set of points per mask; returns (B, N, P) float32. The
gradient reaches the masks only, as in the JAX VJP. On CPU tensors it is
`point_sample_plain`, the `F.grid_sample` call and its autograd gradient.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ...utils.trace import span
from . import check_cuda_tensor, launch


def point_sample_plain(masks: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: `F.grid_sample` of each mask at its points."""
    b, n, h, w = masks.shape
    npts = coords.shape[2]
    grid = (2.0 * coords.detach().to(masks.device, masks.dtype) - 1.0).reshape(b * n, 1, npts, 2)
    out = F.grid_sample(masks.reshape(b * n, 1, h, w), grid, mode="bilinear", padding_mode="zeros",
                        align_corners=False)
    return out.reshape(b, n, npts)


def point_sample_plain_bwd(masks: torch.Tensor, coords: torch.Tensor, grad_out: torch.Tensor) -> torch.Tensor:
    """Plain gradient to the masks: torch's autograd of the plain version."""
    with torch.enable_grad():
        leaf = masks.detach().requires_grad_()
        return torch.autograd.grad(point_sample_plain(leaf, coords), leaf, grad_out)[0]


def source_indices_plain(coords: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """The source index (ix, iy) of each point, float32, as the kernels round
    it: ((2c - 1 + 1) * size - 1) / 2, the product and difference exact in
    float64 (the kernel's fma), then one rounding to float32."""
    g = 2.0 * coords.float() - 1.0
    size = torch.tensor([w, h], dtype=torch.float64, device=coords.device)
    return ((g + 1.0).double() * size - 1.0).float() / 2


def lattice_keys_plain(coords: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Each point's footprint cell on the (h+1) x (w+1) lattice, as the kernel
    keys it ((floor(iy) + 1) * (w + 1) + floor(ix) + 1), or -1 where no corner
    lies in the map."""
    src = source_indices_plain(coords, h, w).floor()
    fx, fy = src[..., 0], src[..., 1]
    touches = (fx >= -1) & (fx <= w - 1) & (fy >= -1) & (fy <= h - 1)
    key = (fy + 1) * (w + 1) + fx + 1
    return torch.where(touches, key, -1.0).long()


def cell_lists_plain(keys: torch.Tensor, cells: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's lists from keys (M, P): (starts (M, cells + 1), each list's
    first entry and, last, the mask's end; lists (M * P,), mask m's points in
    entries [m * P, starts[m, -1]) grouped by cell, ascending within a cell).
    The order of the unique keys cell * P + point, by a sort."""
    m, npts = keys.shape
    key = torch.where(keys >= 0, keys, cells)  # untouched points last
    order = torch.sort(key * npts + torch.arange(npts, device=keys.device), dim=1).values % npts
    counts = torch.zeros(m, cells + 1, dtype=torch.long, device=keys.device)
    counts.scatter_add_(1, key, torch.ones_like(key))
    starts = torch.cumsum(counts, 1) - counts + torch.arange(m, device=keys.device)[:, None] * npts
    return starts, order.reshape(-1)


def point_sample_bwd_ordered_plain(coords: torch.Tensor, grad_out: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """The backward kernel's float32 sum, emulated exactly on any device:
    d masks (B, N, h, w) from coords (B, N, P, 2) and grad_out (B, N, P). Each
    mask cell adds, from 0, the lists of the lattice cells of which it is the
    se, sw, ne and nw corner (`lattice_keys_plain`, `cell_lists_plain`), in
    that order, each list in ascending point order; a term is (wx * wy) * g,
    each product rounded to float32 as the kernel rounds it. All cells at
    once, one list rank at a time."""
    b, n, npts, _ = coords.shape
    m, dev = b * n, coords.device
    src = source_indices_plain(coords, h, w).reshape(m * npts, 2)
    ix, iy = src[:, 0], src[:, 1]
    x0, y0 = ix.floor(), iy.floor()
    g = grad_out.detach().to(dev, torch.float32).reshape(m * npts)
    wx = ((x0 + 1) - ix, ix - x0)  # the point's west, east column
    wy = ((y0 + 1) - iy, iy - y0)  # its north, south row
    lattice = (h + 1) * (w + 1)
    starts, lists = cell_lists_plain(lattice_keys_plain(coords, h, w).reshape(m, npts), lattice)
    lists = lists + torch.arange(m, device=dev).repeat_interleave(npts) * npts  # entries -> flat point index
    cell = torch.arange(m * h * w, device=dev)
    mask, y, x = cell // (h * w), cell // w % h, cell % w
    acc = torch.zeros(m * h * w, dtype=torch.float32, device=dev)
    for k in range(4):  # this cell as the se, sw, ne, nw corner of lattice cell (y + k // 2, x + k % 2)
        c = (y + k // 2) * (w + 1) + x + k % 2
        first = starts[mask, c]
        length = starts[mask, c + 1] - first
        order = torch.argsort(length, descending=True, stable=True)
        active = torch.bincount(length, minlength=1).flip(0).cumsum(0).flip(0).tolist()  # cells with >= r entries
        for r in range(1, len(active)):
            idx = order[: active[r]]
            q = lists[first[idx] + r - 1]
            term = (wx[1 - k % 2][q] * wy[1 - k // 2][q]) * g[q]
            acc[idx] = acc[idx] + term
    return acc.reshape(b, n, h, w)


def _check_launch(coords: torch.Tensor, b: int, n: int) -> None:
    check_cuda_tensor(coords, "coords", (torch.float32,))
    if coords.dim() != 4 or coords.shape[:2] != (b, n) or coords.shape[3] != 2:
        raise ValueError(f"coords has shape {tuple(coords.shape)}; expected ({b}, {n}, P, 2)")
    if b * n * max(coords.shape[2], 1) >= 2**31:
        raise ValueError(f"{b * n} masks of {coords.shape[2]} points: the kernel indexes lists with int32")


def _launch(masks: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """The forward kernel: (B, N, P) float32."""
    check_cuda_tensor(masks, "masks", (torch.float32,))
    b, n, h, w = masks.shape
    _check_launch(coords, b, n)
    npts = coords.shape[2]
    out = torch.empty(b, n, npts, dtype=torch.float32, device=masks.device)
    launch("point_sample", masks.data_ptr(), coords.data_ptr(), out.data_ptr(), b * n, npts, h, w,
           flops=8 * b * n * npts)  # 4 corner weights and 4 multiply-adds per point
    return out


def _launch_bwd(coords: torch.Tensor, grad_out: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """The backward kernel: d masks (B, N, H, W) float32."""
    b, n, npts, _ = coords.shape
    _check_launch(coords, b, n)
    grad_out = grad_out.float().contiguous()
    check_cuda_tensor(grad_out, "grad_out", (torch.float32,))
    if grad_out.shape != (b, n, npts):
        raise ValueError(f"grad_out has shape {tuple(grad_out.shape)}; expected ({b}, {n}, {npts})")
    grad = torch.empty(b, n, h, w, dtype=torch.float32, device=coords.device)
    launch("point_sample_bwd", coords.data_ptr(), grad_out.data_ptr(), grad.data_ptr(), b * n, npts, h, w,
           flops=8 * b * n * npts)  # 4 corner weights and 4 multiply-adds per point
    return grad


class PointSample(torch.autograd.Function):
    """The kernels on the card: forward sampling, backward to the masks only."""

    @staticmethod
    def forward(ctx, masks, coords):
        ctx.save_for_backward(coords)
        ctx.hw = masks.shape[2:]
        return _launch(masks, coords)

    @staticmethod
    @span("op.ps_bwd")
    def backward(ctx, grad_out):
        (coords,) = ctx.saved_tensors
        return _launch_bwd(coords, grad_out, *ctx.hw), None


@span("op.ps")
def point_sample(masks: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """The wrapper: the plain version (and its autograd) for CPU tensors, the
    CUDA kernels forward and backward for CUDA ones."""
    if not masks.is_cuda:
        return point_sample_plain(masks, coords)
    return PointSample.apply(masks.contiguous(), coords.detach().to(masks.device).contiguous())
