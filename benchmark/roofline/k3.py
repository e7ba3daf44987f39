"""K3, the masked cross-attention (`masked_cross_attention`): q (B, H, Q, hd),
k and v (B, H, K, hd), the float32 mask logits (B, Q, K) and all_blocked (B, Q)
read once, the output (q's shape and dtype) written once; q.k and p.v, 2
operations each per (query, key) pair, head and channel, every key counted."""

ENTRY = "rgbdseg_torch.ops.kernels.masked_attention:masked_cross_attention"


def record(q, k, v, mask_logits, all_blocked):
    b, h, nq, hd = q.shape
    es = q.element_size()
    return {
        "flops": 4 * b * h * nq * k.shape[2] * hd,
        "qkv": (q.numel() + k.numel() + v.numel()) * es,
        "q": q.numel() * es,
        "mask": mask_logits.numel() * mask_logits.element_size() + all_blocked.numel() * all_blocked.element_size(),
        "lse": b * h * nq * 4,
        "dtype": str(q.dtype),
    }


def cost(rec):
    """(operations, bytes, operand dtype)."""
    return rec["flops"], rec["qkv"] + rec["q"] + rec["mask"], rec["dtype"]
