"""K1, the deformable attention's sampling of all levels (`deform_sample_levels`):
value (B, L_total, nh, hd), locations (B, L, nh, nl, P, 2), weights (B, L, nh,
nl, P) read once, the float32 output (B, L, nh * hd) written once; 4 corners
of 2 operations (multiply, add) per point and head channel."""

ENTRY = "rgbdseg_torch.ops.kernels.deformable:deform_sample_levels"


def record(value, spatial_shapes, locations, weights):
    b, l, nh, nl, p, _ = locations.shape
    hd = value.shape[-1]
    return {
        "flops": 8 * b * l * nh * nl * p * hd,
        "in": value.numel() * value.element_size() + locations.numel() * locations.element_size()
        + weights.numel() * weights.element_size(),
        "grad_out": b * l * nh * hd * 4,
        "dtype": str(value.dtype),
    }


def cost(rec):
    """(operations, bytes, operand dtype)."""
    return rec["flops"], rec["in"] + rec["grad_out"], rec["dtype"]
