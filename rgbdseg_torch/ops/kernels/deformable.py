"""Deformable-attention sampling for one level (kernel K1).

    out[bh, l, :] = sum_p aw[bh, l, p] * bilinear_zeros(V[bh], gy[bh, l, p], gx[bh, l, p])

Replaces `rgbdseg_tpu/ops/kernels/deformable.py::tent_sample_level`
(`_tent_kernel`) and `::tent_sample_level_band` (`_tent_band_kernel`), which
compute this function as a dense tent matrix times V on the TPU's matrix unit.
The CUDA kernel (`rgbdseg_torch/csrc/deformable.cu`) gathers the 4 bilinear
corners directly, one warp per query with the lanes over the head channels. It
is bound by memory on the H100 (see the source for the bytes and the design).

`deform_sample_level` keeps the JAX signature: gx, gy, aw (BH, L, P) float32,
gx/gy in pixel units (x * w - 0.5); v (BH, h*w, hd) float32 or bfloat16;
returns (BH, L, hd) float32. Forward only.
"""

from __future__ import annotations

import torch

from . import check_cuda_tensor, launch

_CORNERS = ((0, 0), (0, 1), (1, 0), (1, 1))  # (dy, dx)


def deform_sample_level_plain(gx, gy, aw, v, h: int, w: int) -> torch.Tensor:
    """Plain PyTorch version: an explicit 4-corner gather, float32 accumulation."""
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


def deform_sample_level(gx, gy, aw, v, h: int, w: int) -> torch.Tensor:
    """K1 wrapper: the plain version for CPU tensors, the CUDA kernel for CUDA ones."""
    if not gx.is_cuda:
        return deform_sample_level_plain(gx, gy, aw, v, h, w)
    bh, l, npts = gx.shape
    if gy.shape != gx.shape or aw.shape != gx.shape:
        raise ValueError(f"gx {tuple(gx.shape)}, gy {tuple(gy.shape)}, aw {tuple(aw.shape)} must match")
    if v.dim() != 3 or v.shape[0] != bh or v.shape[1] != h * w:
        raise ValueError(f"v has shape {tuple(v.shape)}; expected ({bh}, {h * w}, hd)")
    for t, name in ((gx, "gx"), (gy, "gy"), (aw, "aw")):
        check_cuda_tensor(t, name, (torch.float32,))
    check_cuda_tensor(v, "v", (torch.float32, torch.bfloat16))
    hd = v.shape[2]
    out = torch.empty(bh, l, hd, dtype=torch.float32, device=gx.device)
    launch(
        "deformable",
        gx.data_ptr(), gy.data_ptr(), aw.data_ptr(), v.data_ptr(), out.data_ptr(),
        bh, l, npts, h, w, hd, int(v.dtype == torch.bfloat16),
    )
    return out
