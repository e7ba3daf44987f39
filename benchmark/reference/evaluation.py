"""The reference evaluation: the per-image statistics that the mask mAP reads
(the port's `inference/postprocess.py::eval_stats`: the logits bilinear-resized
to 384x384, the top-Q (query, class) scores, the binary masks nearest-resized
to the GT's size, their areas and their intersections with the GT), and the
mAP over them (`map_metric`, with the port's `Evaluator` rules: threshold 0.0,
scores rounded to 6 decimals, non-empty detections only)."""

from __future__ import annotations

import numpy as np
import torch

from . import ops
from .map_metric import MeanAveragePrecision

PROCESSOR_SIZE = (384, 384)


def _nearest(masks: torch.Tensor, size_hw) -> torch.Tensor:
    if tuple(masks.shape[-2:]) == tuple(size_hw):
        return masks
    h, w = masks.shape[-2:]
    th, tw = size_hw
    yi = np.minimum((np.arange(th) * (h / th)).astype(np.int64), h - 1)
    xi = np.minimum((np.arange(tw) * (w / tw)).astype(np.int64), w - 1)
    masks = masks.index_select(-2, torch.from_numpy(yi).to(masks.device))
    return masks.index_select(-1, torch.from_numpy(xi).to(masks.device))


@torch.no_grad()
def eval_stats(class_logits, mask_logits, gt_masks, gt_valid):
    """(scores (B, Q), labels (B, Q), det areas (B, Q), GT areas (B, T),
    intersections (B, Q, T)) on the logits' device; gt_masks (B, T, H, W) 0/1."""
    b, q, _ = class_logits.shape
    nc = class_logits.shape[-1] - 1
    masks = ops.resize_bilinear(mask_logits.permute(0, 2, 3, 1), PROCESSOR_SIZE).permute(0, 3, 1, 2)
    flat = torch.softmax(class_logits, dim=-1)[..., :-1].reshape(b, q * nc)
    top, idx = torch.sort(flat, dim=-1, descending=True, stable=True)
    top, idx = top[:, :q], idx[:, :q]
    labels = idx % nc
    sel = torch.gather(masks, 1, (idx // nc)[:, :, None, None].expand(-1, -1, *masks.shape[2:]))
    binary = sel > 0
    mask_scores = (torch.sigmoid(sel) * binary.float()).sum(dim=(2, 3)) / (binary.float().sum(dim=(2, 3)) + 1e-6)
    det = _nearest(binary, gt_masks.shape[-2:])
    gt = gt_masks.bool() & gt_valid[:, :, None, None]
    d = det.reshape(b, q, -1).float()
    g = gt.reshape(b, gt.shape[1], -1).float()
    return (top * mask_scores, labels, det.sum(dim=(2, 3)).float(), gt.sum(dim=(2, 3)).float(),
            torch.bmm(d, g.transpose(1, 2)))


def host_stats(stats):
    """The statistics on the host, scores rounded to 6 decimals as the port's evaluator feeds them."""
    scores, labels, darea, garea, inter = (x.cpu().numpy() for x in stats)
    return np.round(scores.astype(np.float64), 6), labels, darea, garea, inter


def mean_average_precision(per_image, id2label, prefix="eval_") -> dict:
    """The mAP keys over per-image (scores, labels, darea, garea, inter, gt_labels, gt_valid) rows, in order."""
    metric = MeanAveragePrecision(class_metrics=True)
    for scores, labels, darea, garea, inter, gt_labels, gt_valid in per_image:
        cand = (scores >= 0.0) & (darea > 0)
        metric.update_precomputed(scores[cand], labels[cand], darea[cand], inter[cand][:, gt_valid],
                                  gt_labels[gt_valid], garea[gt_valid])
    out = metric.compute()
    classes = out.pop("classes", [])
    map_pc = out.pop("map_per_class", [])
    mar_pc = out.pop("mar_100_per_class", [])
    metrics = {prefix + k: float(v) for k, v in out.items()}
    for c, m, r in zip(classes, map_pc, mar_pc):
        name = id2label.get(int(c), str(int(c)))
        metrics[f"{prefix}map_{name}"] = float(m)
        metrics[f"{prefix}mar_100_{name}"] = float(r)
    return metrics
