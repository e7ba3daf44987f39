"""K1's backward: value, locations, weights and the float32 grad_out read once,
d value (value's dtype), d locations and d weights written once; per point,
4 corners of the dot with grad_out and of the d value update, 2 operations
per head channel each."""

BACKWARD_OF = "k1"


def cost(rec):
    """(operations, bytes, operand dtype)."""
    return 2 * rec["flops"], 2 * rec["in"] + rec["grad_out"], rec["dtype"]
