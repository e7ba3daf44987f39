"""K3's backward: q, k, v, the output, d out, the mask, all_blocked and the
float32 log-sum-exp read once, d q, d k, d v written once; the five products
(S, dV, dP, dK, dQ), 2 operations each per (query, key) pair, head and channel."""

BACKWARD_OF = "k3"


def cost(rec):
    """(operations, bytes, operand dtype)."""
    return 2.5 * rec["flops"], 2 * rec["qkv"] + 2 * rec["q"] + rec["mask"] + rec["lse"], rec["dtype"]
