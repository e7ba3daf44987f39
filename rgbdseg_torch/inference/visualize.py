"""Visualisation: prediction overlays and multi-model comparison grids
(counterpart of `rgbdseg_tpu/inference/visualize.py`).

- `overlay_instances`: seeded-colour instance overlay;
- `save_comparison_images`: per-sample image | prediction | GT PNGs, written
  with `data.image_io.write_png`; an original RGB of another size is resized
  with the port's cv2 INTER_LINEAR twin (`ops.resize_exact`);
- `visualize_multi_model_json_results`: GT-consistent grids across models
  from COCO-RLE JSONs (matched predictions take their GT instance's colour,
  unmatched ones are red): one row of panels, "GT" then each model under its
  name, drawn by `utils/raster.py` (the card's machine has no matplotlib)
  and written as `compare_<image id>.png`.
"""

from __future__ import annotations

import json
import os
from collections import defaultdict

import numpy as np
import torch

from ..data.image_io import write_png
from ..ops.resize_exact import cv2_resize_linear_u8
from ..utils import raster
from . import rle as rle_codec
from .export import match_predictions_to_gt
from .postprocess import _resize_nearest_np


def _color_for(idx: int) -> np.ndarray:
    rng = np.random.RandomState(idx * 9973 + 7)
    return rng.randint(60, 255, size=3).astype(np.uint8)


def overlay_instances(image: np.ndarray, masks, colors=None, alpha: float = 0.5) -> np.ndarray:
    out = image.astype(np.float32).copy()
    for i, m in enumerate(masks):
        color = colors[i] if colors is not None else _color_for(i)
        sel = m.astype(bool)
        out[sel] = (1 - alpha) * out[sel] + alpha * color.astype(np.float32)
    return out.astype(np.uint8)


def save_comparison_images(results, dataset, out_dir: str, id2label: dict) -> None:
    os.makedirs(out_dir, exist_ok=True)
    for i, res in enumerate(results):
        pix, gt_masks, gt_classes, valid = dataset[i]
        seg = res["segmentation"]
        res_size = tuple(seg.shape[-2:]) if seg.ndim == 3 else tuple(seg.shape)
        if res_size != pix.shape[:2] and hasattr(dataset, "original_rgb"):
            # results post-processed at the original image size: overlay on the raw image
            img = dataset.original_rgb(i)
            if img.shape[:2] != res_size:
                img = cv2_resize_linear_u8(torch.from_numpy(np.ascontiguousarray(img)), res_size,
                                           has_channels=True).numpy()
        else:
            # un-normalise the preprocessed pixels for display
            img = pix[..., :3]
            img = (img * np.asarray([0.229, 0.224, 0.225]) + np.asarray([0.485, 0.456, 0.406])) * 255.0
            img = np.clip(img, 0, 255).astype(np.uint8)
        if gt_masks[valid].size and gt_masks.shape[-2:] != res_size:
            gt_masks = _resize_nearest_np(gt_masks.astype(np.float32), res_size)
        pred_vis = overlay_instances(img, seg)
        gt_vis = overlay_instances(img, gt_masks[valid])
        grid = np.concatenate([img, pred_vis, gt_vis], axis=1)
        write_png(os.path.join(out_dir, f"comparison_{i}.png"), grid)


def visualize_multi_model_json_results(
    gt_json_path: str,
    model_json_paths: dict[str, str],
    output_dir: str,
    iou_threshold: float = 0.5,
    images: dict | None = None,
) -> None:
    """GT-consistent comparison grids across N models from COCO-RLE JSONs."""
    with open(gt_json_path) as f:
        gt_records = json.load(f)
    model_records = {}
    for name, path in model_json_paths.items():
        with open(path) as f:
            model_records[name] = json.load(f)

    gt_by_img = _group(gt_records)
    models_by_img = {name: _group(records) for name, records in model_records.items()}

    os.makedirs(output_dir, exist_ok=True)
    for img_id, gts in gt_by_img.items():
        gt_masks = [rle_codec.decode(r["segmentation"]) for r in gts]
        h, w = gt_masks[0].shape if gt_masks else (64, 64)
        base = images[img_id] if images and img_id in images else np.full((h, w, 3), 40, np.uint8)
        gt_colors = [_color_for(i) for i in range(len(gt_masks))]

        panels = [("GT", overlay_instances(base, gt_masks, gt_colors))]
        for name, by_img in models_by_img.items():
            preds = by_img.get(img_id, [])
            pmasks = [rle_codec.decode(r["segmentation"]) for r in preds]
            matches = match_predictions_to_gt(pmasks, gt_masks, iou_threshold)
            colors = [np.asarray([255, 0, 0], np.uint8)] * len(pmasks)  # unmatched = red
            for pi, gi, _ in matches:
                colors[pi] = gt_colors[gi]
            panels.append((name, overlay_instances(base, pmasks, colors)))
        write_png(os.path.join(output_dir, f"compare_{img_id}.png"), panel_row(panels))


TITLE_H, PANEL_GAP = 24, 8  # the comparison grid's title strip and the space between panels


def panel_row(panels: list[tuple[str, np.ndarray]]) -> np.ndarray:
    """(title, (h, w, 3) uint8 image) panels of one size side by side on white,
    each under its title."""
    h, w = panels[0][1].shape[:2]
    out = raster.canvas(TITLE_H + h, len(panels) * (w + PANEL_GAP) - PANEL_GAP)
    for i, (title, image) in enumerate(panels):
        x0 = i * (w + PANEL_GAP)
        out[TITLE_H:, x0:x0 + w] = image
        tw, th = raster.text_size(title, 2)
        raster.text(out, x0 + (w - tw) // 2, (TITLE_H - th) // 2, title, scale=2)
    return out


def _group(records):
    by = defaultdict(list)
    for r in records:
        by[r["image_id"]].append(r)
    return by
