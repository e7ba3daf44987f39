"""PS's backward to the masks: the coordinates and grad_out (B, N, P) read
once, the gradient (B, N, H, W) written once; 4 corner weights and 4
multiply-adds per point."""

BACKWARD_OF = "ps"


def cost(rec):
    """(operations, bytes, operand dtype)."""
    npts = rec["coords"].numel() // 2
    return 8 * npts, (rec["coords"].numel() + npts) * 4 + rec["masks_bytes"], rec["dtype"]
