"""Mask2Former masked cross-attention (kernel K3).

Replaces `rgbdseg_tpu/ops/kernels/masked_attention.py::masked_cross_attention`
(`_mca_pallas` / `_mca_kernel`). The CUDA kernel
(`rgbdseg_torch/csrc/masked_attention.cu`) splits the keys: one block per
(batch, head, chunk of 64-key tiles) owns every query, runs a flash-style
online softmax over its tiles (staged with cp.async, double-buffered, register
tiled on the f32 FMA units) with the mask test `m < 0 && !all_blocked`
evaluated inside the kernel, and writes partial (max, sum, accumulator) rows;
a second kernel combines them. A call is those two launches and counts once.

`masked_cross_attention` keeps the JAX signature: q (B, H, Q, hd) pre-scaled by
hd**-0.5; k, v (B, H, K, hd); mask_logits (B, Q, K) float32 raw logits;
all_blocked (B, Q) bool. Returns (B, H, Q, hd) in q's dtype. Forward only.
"""

from __future__ import annotations

import functools

import torch

from . import check_cuda_tensor, launch

NEG_INF = -1e9
TILE_K = 64  # keys per tile of the kernel
MAX_ROWS = 128  # queries per block; more take more query tiles


def masked_cross_attention_plain(q, k, v, mask_logits, all_blocked) -> torch.Tensor:
    """Plain PyTorch version: additive -1e9 mask, float32 softmax, probs in v's dtype."""
    blocked = (mask_logits < 0.0) & ~all_blocked[:, :, None]
    bias = torch.where(blocked[:, None], NEG_INF, 0.0)
    logits = (q @ k.transpose(-1, -2)).float() + bias
    attn = torch.softmax(logits, dim=-1)
    return (attn.to(v.dtype) @ v).to(q.dtype)


@functools.lru_cache(maxsize=None)
def _split_plan(b: int, nh: int, nq: int, nk: int, device_index: int) -> tuple[int, int]:
    """(tiles per split, splits): whole 64-key tiles per block, the fewest per
    block that keep the grid within one wave of two blocks per SM."""
    sms = torch.cuda.get_device_properties(device_index).multi_processor_count
    ntiles = -(-nk // TILE_K)
    blocks_per_split = b * nh * -(-nq // MAX_ROWS)
    tiles_per_split = -(-ntiles * blocks_per_split // (2 * sms))
    return tiles_per_split, -(-ntiles // tiles_per_split)


def masked_cross_attention(q, k, v, mask_logits, all_blocked) -> torch.Tensor:
    """K3 wrapper: the plain version for CPU tensors, the CUDA kernels for CUDA ones."""
    if not q.is_cuda:
        return masked_cross_attention_plain(q, k, v, mask_logits, all_blocked)
    b, nh, nq, hd = q.shape
    nk = k.shape[2]
    if k.shape != (b, nh, nk, hd) or v.shape != k.shape:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} must be ({b}, {nh}, K, {hd})")
    if mask_logits.shape != (b, nq, nk) or all_blocked.shape != (b, nq):
        raise ValueError(
            f"mask_logits {tuple(mask_logits.shape)} / all_blocked {tuple(all_blocked.shape)} "
            f"must be ({b}, {nq}, {nk}) / ({b}, {nq})"
        )
    if hd not in (16, 32, 64) or nk == 0:
        raise ValueError(f"head dim {hd} not in (16, 32, 64), or no keys (K={nk})")
    dtypes = (torch.float32, torch.bfloat16)
    check_cuda_tensor(q, "q", dtypes)
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v dtypes differ: {q.dtype}, {k.dtype}, {v.dtype}")
    check_cuda_tensor(k, "k", dtypes)
    check_cuda_tensor(v, "v", dtypes)
    check_cuda_tensor(mask_logits, "mask_logits", (torch.float32,))
    check_cuda_tensor(all_blocked, "all_blocked", (torch.bool,))
    tiles_per_split, splits = _split_plan(b, nh, nq, nk, q.get_device())
    out = torch.empty_like(q)
    # The splits' partials: accumulators (rows, splits, hd), then (max, sum) pairs.
    parts = b * nh * nq * splits
    scratch = torch.empty(parts * (hd + 2), dtype=torch.float32, device=q.device)
    launch(
        "masked_attention",
        q.data_ptr(), k.data_ptr(), v.data_ptr(), mask_logits.data_ptr(),
        all_blocked.data_ptr(), out.data_ptr(), scratch.data_ptr(), scratch.data_ptr() + parts * hd * 4,
        b, nh, nq, nk, hd, tiles_per_split, splits, int(q.dtype == torch.bfloat16),
    )
    return out
