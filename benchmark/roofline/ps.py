"""PS, the criterion's point sampling of each mask at its own points
(`point_sample`): the mask cells the points' bilinear corners read (each once;
it depends on the points, so the record keeps them and the count is taken
after the trace), the float32 coordinates (B, N, P, 2) and the output (B, N, P);
4 corner weights and 4 multiply-adds per point."""

import torch

ENTRY = "rgbdseg_torch.ops.kernels.point_sample:point_sample"


def record(masks, coords):
    b, n, h, w = masks.shape
    return {"coords": coords.detach(), "hw": (h, w), "masks_bytes": masks.numel() * 4,
            "dtype": str(masks.dtype)}


def touched_cells(coords: torch.Tensor, h: int, w: int) -> int:
    """The distinct in-bounds cells, over all masks, that the points' 4 bilinear
    corners read (align_corners=False: pixel x * w - 0.5)."""
    c = coords.reshape(-1, coords.shape[-2], 2).double()
    x0 = torch.floor(c[..., 0] * w - 0.5).long()
    y0 = torch.floor(c[..., 1] * h - 0.5).long()
    mask = torch.arange(c.shape[0], device=c.device)[:, None]
    cells = []
    for dy in (0, 1):
        for dx in (0, 1):
            y, x = y0 + dy, x0 + dx
            ok = (y >= 0) & (y < h) & (x >= 0) & (x < w)
            cells.append(((mask * h + y) * w + x)[ok])
    return int(torch.unique(torch.cat(cells)).numel())


def cost(rec):
    """(operations, bytes, operand dtype)."""
    c = rec["coords"]
    npts = c.numel() // 2
    return 8 * npts, (touched_cells(c, *rec["hw"]) + c.numel() + npts) * 4, rec["dtype"]
