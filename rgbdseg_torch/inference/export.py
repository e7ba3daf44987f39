"""Batch prediction processing, COCO-RLE JSON export of predictions and GT
(counterpart of `rgbdseg_tpu/inference/export.py`).

- `process_prediction`: post-process each batch's logits at each example's
  original (pre-resize) size, write the prediction and GT JSON and, if asked,
  the comparison PNGs;
- `predictions_to_json` / `gt_to_json`: COCO-RLE records;
- `match_predictions_to_gt`: greedy IoU-sorted assignment.

Datasets are duck-typed as in the JAX package: `dataset[i]` gives
(pixel_values, masks, classes, valid); `original_size(i)` and
`original_rgb(i)` are optional.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np
import torch

from . import rle as rle_codec
from .postprocess import _resize_nearest_np, post_process_instance_segmentation


def predictions_to_json(results: list[dict], image_ids: list) -> list[dict]:
    """Post-processed per-image results -> COCO-RLE record list."""
    records = []
    for img_id, res in zip(image_ids, results):
        seg = res["segmentation"]
        for inst, info in zip(seg, res["segments_info"]):
            records.append(
                {
                    "image_id": img_id,
                    "category_id": int(info["label_id"]),
                    "score": float(info["score"]),
                    "segmentation": rle_codec.encode(inst.astype(bool)),
                }
            )
    return records


def gt_to_json(dataset, image_ids: Optional[list] = None) -> list[dict]:
    """GT masks nearest-resized to each example's original pre-resize size."""
    records = []
    for i in range(len(dataset)):
        _, masks, classes, valid = dataset[i]
        img_id = image_ids[i] if image_ids else i
        orig = _original_size(dataset, i, masks.shape[-2:])
        if tuple(orig) != tuple(masks.shape[-2:]):
            masks = _resize_nearest_np(masks.astype(np.float32), orig)
        for m, c, v in zip(masks, classes, valid):
            if not v:
                continue
            records.append(
                {
                    "image_id": img_id,
                    "category_id": int(c),
                    "score": 1.0,
                    "segmentation": rle_codec.encode(m.astype(bool)),
                }
            )
    return records


def _original_size(dataset, idx: int, fallback) -> tuple[int, int]:
    fn = getattr(dataset, "original_size", None)
    return tuple(fn(idx)) if fn is not None else tuple(fallback)


def match_predictions_to_gt(pred_masks, gt_masks, iou_threshold: float = 0.5):
    """Greedy IoU-sorted matching. Returns a list of (pred_idx, gt_idx, iou)."""
    if len(pred_masks) == 0 or len(gt_masks) == 0:
        return []
    p = np.stack([m.reshape(-1) for m in pred_masks]).astype(np.float64)
    g = np.stack([m.reshape(-1) for m in gt_masks]).astype(np.float64)
    inter = p @ g.T
    union = p.sum(1)[:, None] + g.sum(1)[None, :] - inter
    iou = np.where(union > 0, inter / np.maximum(union, 1), 0.0)
    pairs = [
        (pi, gi, iou[pi, gi])
        for pi in range(iou.shape[0])
        for gi in range(iou.shape[1])
        if iou[pi, gi] >= iou_threshold
    ]
    pairs.sort(key=lambda t: -t[2])
    used_p, used_g, out = set(), set(), []
    for pi, gi, v in pairs:
        if pi in used_p or gi in used_g:
            continue
        used_p.add(pi)
        used_g.add(gi)
        out.append((pi, gi, float(v)))
    return out


def process_prediction(
    outputs: list[tuple],
    dataset,
    id2label: dict,
    prediction_json_path: Optional[str] = None,
    gt_json_path: Optional[str] = None,
    comparison_output_dir: Optional[str] = None,
    threshold: float = 0.5,
) -> list[dict]:
    """outputs: a list of (class_logits (b, Q, L+1), mask_logits (b, Q, h, w))
    per batch, numpy arrays or tensors (post-processed on the tensors' device,
    the CPU for arrays). Post-processing happens at each example's original
    pre-resize size."""
    all_results = []
    image_ids = list(range(len(dataset)))
    idx = 0
    for cls_logits, mask_logits in outputs:
        b = cls_logits.shape[0]
        target_sizes = []
        for i in range(b):
            j = min(idx + i, len(dataset) - 1)
            pix, *_ = dataset[j]
            target_sizes.append(_original_size(dataset, j, pix.shape[:2]))
        res = post_process_instance_segmentation(
            torch.as_tensor(cls_logits), torch.as_tensor(mask_logits), threshold=threshold,
            target_sizes=target_sizes, return_binary_maps=True,
        )
        all_results.extend(res[:b])
        idx += b
    all_results = all_results[: len(dataset)]

    if prediction_json_path:
        os.makedirs(os.path.dirname(prediction_json_path) or ".", exist_ok=True)
        with open(prediction_json_path, "w") as f:
            json.dump(predictions_to_json(all_results, image_ids), f)
    if gt_json_path:
        os.makedirs(os.path.dirname(gt_json_path) or ".", exist_ok=True)
        with open(gt_json_path, "w") as f:
            json.dump(gt_to_json(dataset, image_ids), f)
    if comparison_output_dir:
        from .visualize import save_comparison_images

        save_comparison_images(all_results, dataset, comparison_output_dir, id2label)
    return all_results
