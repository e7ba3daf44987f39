"""Instance-segmentation post-processing
(counterpart of `rgbdseg_tpu/inference/postprocess.py`).

Mask2FormerImageProcessor.post_process_instance_segmentation semantics:
1. bilinear-resize mask logits to the processor's (384, 384), a hard-coded
   constant of the reference stack kept for metric parity;
2. scores = softmax(class)[:, :-1]; flatten (Q*C) and take the top Q;
3. query = index // num_classes; binary mask = logits > 0;
4. mask score = mean sigmoid inside the binary mask; final = class score * mask score;
5. nearest-resize the kept binary masks to the target size; keep score >=
   threshold and non-empty masks.
Every step runs on the model's device; only the kept masks, at the target
size, cross to the host. `eval_stats` (counterpart of `_eval_stats_device`)
keeps even those there and returns the IoU statistics of the mAP.
`_resize_nearest_np` is the same nearest resize for masks already on the host
(overlays at an image's original size, GT export).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..data.device_preprocess import unpack_masks
from ..ops.resize import resize_bilinear

PROCESSOR_SIZE = (384, 384)


def _topq_binary(class_logits, mask_logits, resize_to=PROCESSOR_SIZE):
    """(B, Q, L+1), (B, Q, h, w) -> per-image top-Q (final scores, labels, binary masks at resize_to)."""
    b, q, _ = class_logits.shape
    num_classes = class_logits.shape[-1] - 1
    masks = resize_bilinear(mask_logits.permute(0, 2, 3, 1), resize_to).permute(0, 3, 1, 2)
    scores = torch.softmax(class_logits, dim=-1)[..., :-1]
    flat = scores.reshape(b, q * num_classes)
    # stable descending sort: ties keep the lower index first, as lax.top_k does
    topk_scores, topk_idx = torch.sort(flat, dim=-1, descending=True, stable=True)
    topk_scores, topk_idx = topk_scores[:, :q], topk_idx[:, :q]
    labels = topk_idx % num_classes
    query_idx = topk_idx // num_classes
    sel = torch.gather(masks, 1, query_idx[:, :, None, None].expand(-1, -1, *masks.shape[2:]))
    binary_bool = sel > 0
    binary = binary_bool.float()
    probs = torch.sigmoid(sel)
    mask_scores = (probs * binary).sum(dim=(2, 3)) / (binary.sum(dim=(2, 3)) + 1e-6)
    return topk_scores * mask_scores, labels, binary_bool


def _nearest_indices(src_hw, dst_hw) -> tuple[np.ndarray, np.ndarray]:
    """torch F.interpolate(mode='nearest') row and column indices, with the JAX
    package's float64 formula `floor(dst * in / out)`, so they are its indices."""
    h, w = src_hw
    th, tw = dst_hw
    yi = np.minimum((np.arange(th) * (h / th)).astype(np.int64), h - 1)
    xi = np.minimum((np.arange(tw) * (w / tw)).astype(np.int64), w - 1)
    return yi, xi


def _resize_nearest_np(mask: np.ndarray, size_hw) -> np.ndarray:
    """The host twin of `_resize_nearest` on (N, H, W) arrays (the JAX package's
    `_resize_nearest_np`), with the same `_nearest_indices`."""
    yi, xi = _nearest_indices(mask.shape[-2:], size_hw)
    return mask[:, yi[:, None], xi[None, :]]


def _resize_nearest(masks: torch.Tensor, size_hw) -> torch.Tensor:
    """Nearest resize of (..., H, W) to `size_hw` (`_nearest_indices`)."""
    if tuple(masks.shape[-2:]) == tuple(size_hw):
        return masks
    yi, xi = _nearest_indices(masks.shape[-2:], size_hw)
    masks = masks.index_select(-2, torch.from_numpy(yi).to(masks.device))
    return masks.index_select(-1, torch.from_numpy(xi).to(masks.device))


@torch.no_grad()
def eval_stats(class_logits, mask_logits, gt_packed, gt_valid, target_hw, gt_hw, resize_to=PROCESSOR_SIZE):
    """Instance-eval statistics on the logits' device: all that mask mAP needs
    except the masks, so only O(Q*T) numbers leave the device.

    gt_packed: (B, T, ceil(gh*gw/8)) uint8, np.packbits of the padded GT masks
    at gt_hw; gt_valid: (B, T) bool. Returns (scores (B, Q) float32, labels
    (B, Q) int64, darea (B, Q), garea (B, T), inter (B, Q, T) float32): the
    detection masks binarised at `resize_to` and nearest-resized to
    `target_hw`, the GT nearest-resized from gt_hw, with the host path's
    indices. The counts are integers below 2^24, summed exactly: the
    intersections as a float32 product of 0/1 operands (float32 accumulation
    of integers is exact there; a bfloat16 product would round its output).
    """
    scores, labels, det = _topq_binary(class_logits, mask_logits, resize_to)
    b, q = labels.shape
    t = gt_valid.shape[1]
    det = _resize_nearest(det, target_hw)
    gt = unpack_masks(gt_packed, gt_hw).bool() & gt_valid[:, :, None, None]
    gt = _resize_nearest(gt, target_hw)
    d = det.reshape(b, q, -1).to(torch.float32)
    g = gt.reshape(b, t, -1).to(torch.float32)
    inter = torch.bmm(d, g.transpose(1, 2))
    darea = det.sum(dim=(2, 3)).to(torch.float32)
    garea = gt.sum(dim=(2, 3)).to(torch.float32)
    return scores, labels, darea, garea, inter


@torch.no_grad()
def post_process_instance_segmentation(
    class_logits: torch.Tensor,
    mask_logits: torch.Tensor,
    threshold: float = 0.5,
    target_sizes: Optional[list[tuple[int, int]]] = None,
    return_binary_maps: bool = True,
) -> list[dict]:
    """Per image: {"segmentation": (N, H, W) uint8 0/1 binary maps (or an (H, W)
    float32 id map when return_binary_maps=False), "segments_info": [...]}."""
    final_scores, labels, binary = _topq_binary(class_logits, mask_logits)
    nonempty = binary.any(dim=3).any(dim=2)
    scores_np = final_scores.cpu().numpy()
    labels_np = labels.cpu().numpy()
    nonempty_np = nonempty.cpu().numpy()
    ph, pw = PROCESSOR_SIZE

    results = []
    for i in range(scores_np.shape[0]):
        # An empty mask stays empty under nearest resize, so filter first and
        # move only the candidates' masks to the host.
        cand = np.nonzero((scores_np[i] >= threshold) & nonempty_np[i])[0]
        masks_i = binary[i].index_select(0, torch.from_numpy(cand).to(binary.device))
        h, w = ph, pw
        if target_sizes is not None:
            h, w = target_sizes[i]
            if (h, w) != (ph, pw):
                masks_i = _resize_nearest(masks_i, (h, w))
        still = masks_i.flatten(1).any(dim=1)
        masks_i = masks_i[still].to(torch.uint8).cpu().numpy()
        cand = cand[still.cpu().numpy()]
        segments = [
            {"id": k, "label_id": int(labels_np[i, j]), "was_fused": False, "score": round(float(scores_np[i, j]), 6)}
            for k, j in enumerate(cand)
        ]
        if return_binary_maps:
            seg = masks_i
        else:
            seg = np.full((h, w), -1.0, np.float32)
            for k in range(masks_i.shape[0]):
                seg[masks_i[k] == 1] = k
        results.append({"segmentation": seg, "segments_info": segments})
    return results
