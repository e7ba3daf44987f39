"""Mask QA viewer: overlay instance/semantic masks for visual validation
(counterpart of `rgbdseg_tpu/tools/mask_check.py`, without cv2).

Capability parity with custom_mask_check.visualize_masks (reference:
custom_mask_check.py:80-236) and label_check (data_process.py:169-222):
deterministic per-id colors, instance + semantic overlays, saved to disk
(headless) instead of plt.show().

The overlays are composed in torch on the card unless `device` names another
(`parallel/mesh.py::mesh_device`), bit for bit what the JAX tool's numpy
gives: the image read as ``cv2.imread`` + ``COLOR_BGR2RGB`` read it
(`data/image_io.load_color`), the mask as ``IMREAD_UNCHANGED``, a size
mismatch resized by cv2 INTER_LINEAR's twin (`ops/resize_exact`), the blend
in float64 truncated to uint8 as numpy's ``astype`` truncates.

    python -m rgbdseg_torch.tools.mask_check --meta train.json --root set --out_dir checks [--limit 8] \
        [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from ..data.image_io import load_color, load_unchanged, write_png
from ..ops.resize_exact import cv2_resize_linear_u8
from ..parallel.mesh import mesh_device


def _id_color(idx: int) -> np.ndarray:
    rng = np.random.RandomState(int(idx) * 7919 + 13)
    return rng.randint(50, 255, size=3).astype(np.uint8)


def colorize_ids(id_map: torch.Tensor) -> torch.Tensor:
    """(H, W) integer ids -> (H, W, 3) uint8 colours, id 0 black."""
    ids = id_map.long()
    present = torch.unique(ids).tolist()
    table = np.zeros((max(present) + 1, 3), np.uint8)
    for i in present:
        if i:
            table[i] = _id_color(i)
    return torch.from_numpy(table).to(ids.device)[ids]


def visualize_masks(
    image_path: str,
    mask_path: str,
    save_path: str | None = None,
    alpha: float = 0.5,
    device=None,
) -> np.ndarray:
    """Side-by-side: image | instance overlay | semantic overlay."""
    dev = mesh_device(device)
    img = torch.from_numpy(load_color(image_path)).to(dev)
    mask = load_unchanged(mask_path)
    inst = torch.from_numpy(mask[..., 1].astype(np.int32)).to(dev)
    sem = torch.from_numpy(mask[..., 2].astype(np.int32)).to(dev)
    if img.shape[:2] != inst.shape:
        img = cv2_resize_linear_u8(img, tuple(inst.shape), has_channels=True)
    base = img.to(torch.float64) * (1 - alpha)

    def blend(ids):  # ((1 - alpha) * img + alpha * colours).astype(uint8)
        return (base + colorize_ids(ids).to(torch.float64) * alpha).to(torch.uint8)

    grid = torch.cat([img, blend(inst), blend(sem)], dim=1).cpu().numpy()
    if save_path:
        os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
        write_png(save_path, grid)
    return grid


def label_check(meta_json: str, root: str, out_dir: str, limit: int | None = None, device=None) -> int:
    """Run visualize_masks over a meta file; returns number of checked images."""
    with open(meta_json) as f:
        records = json.load(f)
    n = 0
    for i, rec in enumerate(records[: limit or len(records)]):
        img = rec["image"][0] if isinstance(rec["image"], list) else rec["image"]
        visualize_masks(
            os.path.join(root, img),
            os.path.join(root, rec["annotation"]),
            os.path.join(out_dir, f"check_{i}.png"),
            device=device,
        )
        n += 1
    return n


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Overlay a meta file's masks on its images")
    ap.add_argument("--meta", required=True)
    ap.add_argument("--root", default="")
    ap.add_argument("--out_dir", default="mask_check")
    ap.add_argument("--limit", type=int, default=None)
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    n = label_check(args.meta, args.root, args.out_dir, args.limit, args.device)
    print(f"wrote {n} checks to {args.out_dir}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
