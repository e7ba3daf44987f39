"""Visual QA viewers of the fusion path's intermediates, CSF and DSAM
(counterpart of `rgbdseg_tpu/tools/qa_viewers.py`; the reference's
csf_viewer_v2, data_process.py:922-1016, and DSAModule's histogram_viewer /
depth_region_viewer, custom_model.py:800-820).

Each viewer runs the port's own ops (`ops/csf.py::csf_intermediates`,
`ops/depth_decomp.py::{depth_histogram, select_modes, dsam_region_masks}`) on
the card unless `device` names another, so what it shows is what the model
computes, and returns their intermediates as numpy arrays with the panel it
drew, a uint8 image (`"image"`), written as a PNG when `save` is given
(`data/image_io.write_png`). It draws without matplotlib, which the card's
machine lacks: heat maps go through `JET`, a 256-entry table of matplotlib's
"jet" segments, gray maps are scaled to 0-255, and the histogram is a bar
image with its modes' windows shaded and their centres marked.

    python -m rgbdseg_torch.tools.qa_viewers csf --images a.png b.png ... [--save csf_qa.png] [--device cpu]
    python -m rgbdseg_torch.tools.qa_viewers dsam --depth d.png [--ratio 0.2] [--device cpu]
"""

from __future__ import annotations

import argparse
from typing import Optional

import numpy as np
import torch

from ..data.image_io import load_gray, write_png
from ..ops.csf import csf_intermediates
from ..ops.depth_decomp import depth_histogram, dsam_region_masks, select_modes
from ..parallel.mesh import mesh_device

# matplotlib's "jet" (its _jet_data segments) sampled at 256 levels.
_JET_SEGMENTS = {
    0: ((0.0, 0.0), (0.35, 0.0), (0.66, 1.0), (0.89, 1.0), (1.0, 0.5)),
    1: ((0.0, 0.0), (0.125, 0.0), (0.375, 1.0), (0.64, 1.0), (0.91, 0.0), (1.0, 0.0)),
    2: ((0.0, 0.5), (0.11, 1.0), (0.34, 1.0), (0.65, 0.0), (1.0, 0.0)),
}
_LEVELS = np.linspace(0.0, 1.0, 256)
JET = np.stack([np.round(255 * np.interp(_LEVELS, *zip(*_JET_SEGMENTS[c]))) for c in range(3)],
               -1).astype(np.uint8)
# Mode colours (matplotlib's C0-C2, then gray) and the panels' gap.
MODE_COLOURS = np.array([[31, 119, 180], [255, 127, 14], [44, 160, 44], [127, 127, 127]], np.uint8)
GAP = 2


def heat(x: np.ndarray, lo: float, hi: float) -> np.ndarray:
    """(H, W) values -> (H, W, 3) uint8 through JET over [lo, hi]; non-finite values black."""
    t = np.clip((np.nan_to_num(x, nan=lo, posinf=hi, neginf=lo) - lo) / max(hi - lo, 1e-12), 0.0, 1.0)
    out = JET[np.round(t * 255).astype(np.int64)]
    out[~np.isfinite(x)] = 0
    return out


def gray(x: np.ndarray, hi: Optional[float] = None) -> np.ndarray:
    """(H, W) or (H, W, C) values in [0, hi] (default: their max) -> (H, W, 3) uint8."""
    hi = float(np.max(x)) if hi is None else hi
    t = np.clip(np.asarray(x, np.float64) / max(hi, 1e-6), 0.0, 1.0)
    t = t[..., 0] if t.ndim == 3 and t.shape[-1] == 1 else t
    u = np.round(t * 255).astype(np.uint8)
    return np.repeat(u[..., None], 3, -1) if u.ndim == 2 else u[..., :3]


def grid(tiles: list[list[Optional[np.ndarray]]]) -> np.ndarray:
    """Rows of equal-sized (h, w, 3) uint8 tiles (None: blank) -> one image, GAP white pixels apart."""
    h, w = next(t for row in tiles for t in row if t is not None).shape[:2]
    rows, cols = len(tiles), max(len(r) for r in tiles)
    out = np.full((rows * (h + GAP) - GAP, cols * (w + GAP) - GAP, 3), 255, np.uint8)
    for i, row in enumerate(tiles):
        for j, t in enumerate(row):
            if t is not None:
                out[i * (h + GAP):i * (h + GAP) + h, j * (w + GAP):j * (w + GAP) + w] = t
    return out


def _finish(result: dict, save: Optional[str]) -> dict:
    if save:
        write_png(save, result["image"])
        result["path"] = save
    return result


def _numpy(d: dict) -> dict:
    return {k: v.cpu().numpy() for k, v in d.items()}


def csf_viewer(images: np.ndarray, save: Optional[str] = None, device=None) -> dict:
    """CSF's intermediates of an (N, H, W, C) float or uint8 modality stack
    (`csf_intermediates`' dict: sim, best, round_images, counts, scores,
    weights, fused) and their panel: one row per round, its similarity map
    against each other image on [-1, 1] (the round's own column blank), its
    round image at the right."""
    dev = mesh_device(device)
    inter = _numpy(csf_intermediates(torch.from_numpy(np.asarray(images)).to(dev)))
    n = images.shape[0]
    tiles = [[None if j == rnd else heat(inter["sim"][rnd, j], -1.0, 1.0) for j in range(n)]
             + [gray(inter["round_images"][rnd])] for rnd in range(n)]
    return _finish({**inter, "image": grid(tiles)}, save)


def dsam_histogram_viewer(depth: np.ndarray, ratio: float = 0.2, num_modes: int = 3, bins: int = 512,
                          save: Optional[str] = None, device=None, height: int = 200) -> dict:
    """The depth histogram (hist, lo, width) with the selected modes (centers,
    valid), drawn as `bins` one-pixel bars of `height` pixels; each valid
    mode's window, centre +- centre * ratio / 2, shaded in its colour and its
    centre marked by a line."""
    dev = mesh_device(device)
    hist, lo, width = depth_histogram(torch.as_tensor(np.asarray(depth, np.float32), device=dev)[None], bins)
    centers, valid = select_modes(hist, lo, width, num_modes)
    out = {"hist": hist[0].cpu().numpy(), "lo": lo[0].cpu().numpy(), "width": width[0].cpu().numpy(),
           "centers": centers[0].cpu().numpy(), "valid": valid[0].cpu().numpy()}
    image = np.full((height, bins, 3), 255, np.uint8)
    col = lambda v: int(np.clip(np.floor((v - out["lo"]) / out["width"]), 0, bins - 1))  # noqa: E731
    for i, (c, v) in enumerate(zip(out["centers"], out["valid"])):
        if v:
            half = c * ratio / 2.0
            span = slice(col(max(0.0, c - half)), col(c + half) + 1)
            image[:, span] = (0.8 * image[:, span] + 0.2 * MODE_COLOURS[min(i, 3)]).astype(np.uint8)
    tops = np.round(out["hist"] / max(float(out["hist"].max()), 1e-12) * height).astype(np.int64)
    rows = np.arange(height)[:, None]
    image[rows >= height - tops[None, :]] = 119
    for i, (c, v) in enumerate(zip(out["centers"], out["valid"])):
        if v:
            image[:, col(c)] = MODE_COLOURS[min(i, 3)]
    out["image"] = image
    return _finish(out, save)


def dsam_region_viewer(depth: np.ndarray, ratio: float = 0.2, num_modes: int = 3, save: Optional[str] = None,
                       device=None) -> dict:
    """The region masks of the full decomposition (`dsam_region_masks`: masks
    (T+1, H, W), active (T+1,)) beside the depth as a heat map; slots below K
    are windows, slot K the remainder, the rest inactive."""
    dev = mesh_device(device)
    masks, active = dsam_region_masks(torch.as_tensor(np.asarray(depth, np.float32), device=dev)[None],
                                      torch.tensor([ratio], dtype=torch.float32, device=dev), num_modes=num_modes)
    out = {"masks": masks[0].cpu().numpy(), "active": active[0].cpu().numpy()}
    d = np.asarray(depth, np.float32)
    out["image"] = grid([[heat(d, float(d.min()), float(d.max()))] + [gray(m, 1.0) for m in out["masks"]]])
    return _finish(out, save)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="Fusion-path visual QA viewers")
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA device)")
    sub = ap.add_subparsers(dest="cmd", required=True)
    p1 = sub.add_parser("csf", help="CSF intermediates for a modality stack")
    p1.add_argument("--images", nargs="+", required=True, help="modality image paths")
    p1.add_argument("--save", default="csf_qa.png")
    p2 = sub.add_parser("dsam", help="DSAM histogram + region masks for a depth map")
    p2.add_argument("--depth", required=True, help="depth image path (grayscale)")
    p2.add_argument("--ratio", type=float, default=0.2)
    p2.add_argument("--save_hist", default="dsam_hist_qa.png")
    p2.add_argument("--save_regions", default="dsam_regions_qa.png")
    args = ap.parse_args(argv)
    if args.cmd == "csf":
        csf_viewer(np.stack([load_gray(p)[..., None].astype(np.float32) for p in args.images]), save=args.save,
                   device=args.device)
        print(f"wrote {args.save}")
    else:
        depth = load_gray(args.depth).astype(np.float32)
        dsam_histogram_viewer(depth, ratio=args.ratio, save=args.save_hist, device=args.device)
        dsam_region_viewer(depth, ratio=args.ratio, save=args.save_regions, device=args.device)
        print(f"wrote {args.save_hist} {args.save_regions}")


if __name__ == "__main__":
    main()
