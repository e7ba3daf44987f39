"""Mask2Former masked cross-attention (kernel K3).

Replaces `rgbdseg_tpu/ops/kernels/masked_attention.py::masked_cross_attention`
(`_mca_pallas` / `_mca_kernel`). The CUDA kernel
(`rgbdseg_torch/csrc/masked_attention.cu`) runs a flash-style online softmax
over key tiles staged in shared memory, one block per (batch, head, tile of 8
queries) and one warp per query, with the mask test `m < 0 && !all_blocked`
evaluated inside the kernel. At the main path's shapes it is bound by f32
operations on the H100 (see the source for the numbers and the design).

`masked_cross_attention` keeps the JAX signature: q (B, H, Q, hd) pre-scaled by
hd**-0.5; k, v (B, H, K, hd); mask_logits (B, Q, K) float32 raw logits;
all_blocked (B, Q) bool. Returns (B, H, Q, hd) in q's dtype. Forward only.
"""

from __future__ import annotations

import torch

from . import check_cuda_tensor, launch

NEG_INF = -1e9


def masked_cross_attention_plain(q, k, v, mask_logits, all_blocked) -> torch.Tensor:
    """Plain PyTorch version: additive -1e9 mask, float32 softmax, probs in v's dtype."""
    blocked = (mask_logits < 0.0) & ~all_blocked[:, :, None]
    bias = torch.where(blocked[:, None], NEG_INF, 0.0)
    logits = (q @ k.transpose(-1, -2)).float() + bias
    attn = torch.softmax(logits, dim=-1)
    return (attn.to(v.dtype) @ v).to(q.dtype)


def masked_cross_attention(q, k, v, mask_logits, all_blocked) -> torch.Tensor:
    """K3 wrapper: the plain version for CPU tensors, the CUDA kernel for CUDA ones."""
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
    if hd not in (16, 32, 64):
        raise ValueError(f"head dim {hd} not in (16, 32, 64)")
    dtypes = (torch.float32, torch.bfloat16)
    check_cuda_tensor(q, "q", dtypes)
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v dtypes differ: {q.dtype}, {k.dtype}, {v.dtype}")
    check_cuda_tensor(k, "k", dtypes)
    check_cuda_tensor(v, "v", dtypes)
    check_cuda_tensor(mask_logits, "mask_logits", (torch.float32,))
    check_cuda_tensor(all_blocked, "all_blocked", (torch.bool,))
    out = torch.empty_like(q)
    launch(
        "masked_attention",
        q.data_ptr(), k.data_ptr(), v.data_ptr(), mask_logits.data_ptr(),
        all_blocked.data_ptr(), out.data_ptr(),
        b, nh, nq, nk, hd, int(q.dtype == torch.bfloat16),
    )
    return out
