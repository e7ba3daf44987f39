"""Mask2Former masked cross-attention (kernel K3).

Replaces `rgbdseg_tpu/ops/kernels/masked_attention.py::masked_cross_attention`
(`_mca_pallas` / `_mca_kernel`) and its backward (`_bwd`, the VJP of the jnp
twin). The forward CUDA kernel (`rgbdseg_torch/csrc/masked_attention.cu`)
splits the keys: one block per (batch, head, chunk of 64-key tiles) owns every
query, runs a flash-style online softmax over its tiles (staged with cp.async,
double-buffered; q.k and p.v on the tensor cores as 3xTF32 `mma.sync` in
float32, as bf16 `mma.sync` m16n8k16 with p rounded to bf16 before p.v, where
the JAX kernel rounds it, in bfloat16) with the
mask test `m < 0 && !all_blocked` evaluated inside the kernel, and writes
partial (max, sum, accumulator) rows; a second kernel combines them and writes
each row's log-sum-exp. The backward (`rgbdseg_torch/csrc/masked_attention_bwd.cu`)
turns the mask test into bits, then reuses the forward's split: per 64-key
tile it recomputes the probabilities from the log-sum-exp, runs its five
products as 3xTF32 `mma.sync` (float32) or as bf16 `mma.sync` m16n8k16 with
P and dS rounded to bf16 where the JAX VJP rounds them (bfloat16), writes dK
and dV of its keys and a partial dQ, which a third kernel sums over the splits
in order; all three come out in q's dtype. Each call counts once: the forward
is two launches, the backward three.

`masked_cross_attention` keeps the JAX signature: q (B, H, Q, hd) pre-scaled by
hd**-0.5; k, v (B, H, K, hd); mask_logits (B, Q, K) float32 raw logits;
all_blocked (B, Q) bool. Returns (B, H, Q, hd) in q's dtype. Gradients reach q,
k and v; the masks get none. The plain backward is torch's autograd of the
plain forward, which has no tie convention to match; on bf16 tensors it rounds
where the JAX VJP does (P before d v, d S before d q and d k, and d P, which the
kernel keeps in float32).
"""

from __future__ import annotations

import functools

import torch

from ...utils.trace import span
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
def _split_plan(b: int, nh: int, nq: int, nk: int, device_index: int, per_sm: int = 2) -> tuple[int, int]:
    """(tiles per split, splits): whole 64-key tiles per block, the fewest per
    block that keep the grid within one wave of `per_sm` blocks per SM."""
    sms = torch.cuda.get_device_properties(device_index).multi_processor_count
    ntiles = -(-nk // TILE_K)
    blocks_per_split = b * nh * -(-nq // MAX_ROWS)
    tiles_per_split = -(-ntiles * blocks_per_split // (per_sm * sms))
    return tiles_per_split, -(-ntiles // tiles_per_split)


def masked_cross_attention_plain_bwd(q, k, v, mask_logits, all_blocked, grad_out):
    """Plain gradient (d q, d k, d v): torch's autograd of the plain version."""
    with torch.enable_grad():
        qkv = [t.detach().requires_grad_() for t in (q, k, v)]
        out = masked_cross_attention_plain(*qkv, mask_logits, all_blocked)
        return torch.autograd.grad(out, qkv, grad_out)


def _check_launch(q, k, v, mask_logits, all_blocked, per_sm: int = 2):
    """Shapes, dtypes and layouts the K3 kernels take; returns (B, H, Q, K, hd,
    tiles per split, splits) for a grid of `per_sm` blocks per SM."""
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
    return (b, nh, nq, nk, hd, *_split_plan(b, nh, nq, nk, q.get_device(), per_sm))


def _launch(q, k, v, mask_logits, all_blocked):
    """The forward kernels; returns the output and each row's log-sum-exp (B, H, Q) float32."""
    b, nh, nq, nk, hd, tiles_per_split, splits = _check_launch(q, k, v, mask_logits, all_blocked)
    out = torch.empty_like(q)
    lse = torch.empty(b, nh, nq, dtype=torch.float32, device=q.device)
    # The splits' partials: accumulators (rows, splits, hd), then (max, sum) pairs.
    parts = b * nh * nq * splits
    scratch = torch.empty(parts * (hd + 2), dtype=torch.float32, device=q.device)
    launch(
        "masked_attention",
        q.data_ptr(), k.data_ptr(), v.data_ptr(), mask_logits.data_ptr(),
        all_blocked.data_ptr(), out.data_ptr(), scratch.data_ptr(), scratch.data_ptr() + parts * hd * 4,
        lse.data_ptr(), b, nh, nq, nk, hd, tiles_per_split, splits, int(q.dtype == torch.bfloat16),
        flops=4 * b * nh * nq * nk * hd,  # q k^T and p v over every key
    )
    return out, lse


def _launch_bwd(q, k, v, mask_logits, all_blocked, out, lse, grad_out):
    """The backward kernels; returns (d q, d k, d v) in q's dtype."""
    # The bf16 kernel fits three blocks per SM at hd <= 32 (half the shared memory of the f32 one).
    per_sm = 3 if q.dtype == torch.bfloat16 and q.shape[-1] <= 32 else 2
    b, nh, nq, nk, hd, tiles_per_split, splits = _check_launch(q, k, v, mask_logits, all_blocked, per_sm)
    grad_out = grad_out.to(q.dtype).contiguous()
    check_cuda_tensor(out, "out", (q.dtype,))
    check_cuda_tensor(lse, "lse", (torch.float32,))
    if grad_out.shape != out.shape or lse.shape != (b, nh, nq):
        raise ValueError(f"grad_out {tuple(grad_out.shape)} / lse {tuple(lse.shape)} must be "
                         f"{tuple(out.shape)} / ({b}, {nh}, {nq})")
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))  # the kernels write q's dtype
    # Scratch: the splits' dQ partials, then the mask as bits (2 words per 64-key tile and query).
    dq_part = torch.empty(b * nh * nq * splits * hd + b * nq * 2 * -(-nk // TILE_K), dtype=torch.float32,
                          device=q.device)
    launch(
        "masked_attention_bwd",
        q.data_ptr(), k.data_ptr(), v.data_ptr(), mask_logits.data_ptr(), all_blocked.data_ptr(),
        out.data_ptr(), grad_out.data_ptr(), lse.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        dq_part.data_ptr(), b, nh, nq, nk, hd, tiles_per_split, splits, int(q.dtype == torch.bfloat16),
        flops=10 * b * nh * nq * nk * hd,  # q k^T again, d v, d p, d q and d k over every key
    )
    return dq, dk, dv


class MaskedCrossAttention(torch.autograd.Function):
    """K3 on the card, forward and backward; the forward saves each row's log-sum-exp."""

    @staticmethod
    def forward(ctx, q, k, v, mask_logits, all_blocked):
        out, lse = _launch(q, k, v, mask_logits, all_blocked)
        ctx.save_for_backward(q, k, v, mask_logits, all_blocked, out, lse)
        return out

    @staticmethod
    @span("op.k3_bwd")
    def backward(ctx, grad_out):
        dq, dk, dv = _launch_bwd(*ctx.saved_tensors, grad_out)
        return dq, dk, dv, None, None


@span("op.k3")
def masked_cross_attention(q, k, v, mask_logits, all_blocked) -> torch.Tensor:
    """K3 wrapper: the plain version (and its autograd) for CPU tensors, the
    CUDA kernels forward and backward for CUDA ones."""
    if not q.is_cuda:
        return masked_cross_attention_plain(q, k, v, mask_logits, all_blocked)
    return MaskedCrossAttention.apply(q, k, v, mask_logits, all_blocked)
