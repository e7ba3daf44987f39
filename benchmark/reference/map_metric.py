"""COCO-style mask mAP (iou_type="segm"), pure numpy: the benchmark's frozen
copy of the port's `train/map_metric.py`, so that the reference's mAP does not
move when the port's does.

Replaces the reference's torchmetrics MeanAveragePrecision(iou_type="segm",
class_metrics=True) (reference: model_essential_part.py:56-58) with a
self-contained implementation of the COCOeval protocol: 10 IoU thresholds
0.50:0.05:0.95, 101-point interpolated precision, area ranges
all/small/medium/large, maxDets (1, 10, 100), per-class metrics.

API mirrors the streaming metric: `update(preds, targets)` per batch with
 preds:   [{"scores": (N,), "labels": (N,), "masks": (N, H, W) bool}]
 targets: [{"labels": (M,), "masks": (M, H, W) bool}]
then `compute()` -> dict of floats (+ per-class arrays).
"""

from __future__ import annotations

import numpy as np

IOU_THRS = np.round(np.arange(0.5, 1.0, 0.05), 2)
REC_THRS = np.linspace(0.0, 1.0, 101)
AREA_RANGES = {
    "all": (0.0, 1e10),
    "small": (0.0, 32.0**2),
    "medium": (32.0**2, 96.0**2),
    "large": (96.0**2, 1e10),
}
MAX_DETS = (1, 10, 100)


def mask_iou(dets: np.ndarray, gts: np.ndarray) -> np.ndarray:
    """(N, H, W) bool x (M, H, W) bool -> (N, M) IoU."""
    if dets.shape[0] == 0 or gts.shape[0] == 0:
        return np.zeros((dets.shape[0], gts.shape[0]), np.float64)
    # f32 dot: intersection/area counts are integers < 2^24, so f32 is EXACT
    # and the matmul runs 2x faster in half the memory; the division happens
    # in f64 so the resulting IoUs are bit-identical to the f64 path.
    d = dets.reshape(dets.shape[0], -1).astype(np.float32)
    g = gts.reshape(gts.shape[0], -1).astype(np.float32)
    inter = (d @ g.T).astype(np.float64)
    union = d.sum(1, dtype=np.float64)[:, None] + g.sum(1, dtype=np.float64)[None, :] - inter
    return np.where(union > 0, inter / np.maximum(union, 1), 0.0)


class MeanAveragePrecision:
    def __init__(self, class_metrics: bool = True):
        self.class_metrics = class_metrics
        self.reset()

    def reset(self):
        # Streaming accumulation: masks are reduced to per-(image, class)
        # stats (scores, areas, IoU matrix) at update() time and DROPPED —
        # holding raw masks until compute() would cost ~20 GB at NYUv2 scale
        # (654 images x 100+ masks x 640x480). torchmetrics/pycocotools
        # stream the same way (per-image evaluateImg, accumulate at the end).
        self._stats: dict[int, list[dict]] = {}  # class -> per-image stats
        self._gt_classes: set[int] = set()

    def update(self, preds: list[dict], targets: list[dict]):
        for p, t in zip(preds, targets):
            pred = {
                "scores": np.asarray(p["scores"], np.float64),
                "labels": np.asarray(p["labels"], np.int64),
                "masks": np.asarray(p["masks"], bool),
            }
            tgt = {
                "labels": np.asarray(t["labels"], np.int64),
                "masks": np.asarray(t["masks"], bool),
            }
            self._gt_classes.update(int(c) for c in tgt["labels"])
            for cls in set(pred["labels"].tolist()) | set(tgt["labels"].tolist()):
                self._stats.setdefault(int(cls), []).append(
                    self._image_class_stats(pred, tgt, int(cls))
                )

    def update_precomputed(self, scores, labels, darea, inter, gt_labels, garea):
        """Per-image update from precomputed quantities (no masks): inter[i, j]
        = |det_i ∩ gt_j| in pixels at the evaluation size, areas in pixels.
        Dets must already be threshold/nonempty-filtered; rows in detection
        order (ties in the per-class score sort break by that order, exactly
        like the mask path). Produces stats identical to `update` whenever
        inter/areas match the mask counts (the device eval path guarantees
        this exactly — see inference/postprocess._eval_stats_device)."""
        scores = np.asarray(scores, np.float64)
        labels = np.asarray(labels, np.int64)
        darea = np.asarray(darea, np.float64)
        inter = np.asarray(inter, np.float64)
        gt_labels = np.asarray(gt_labels, np.int64)
        garea = np.asarray(garea, np.float64)
        self._gt_classes.update(int(c) for c in gt_labels)
        for cls in set(labels.tolist()) | set(gt_labels.tolist()):
            sel_d = np.nonzero(labels == cls)[0]
            sel_d = sel_d[np.argsort(-scores[sel_d], kind="mergesort")]
            sel_g = np.nonzero(gt_labels == cls)[0]
            inter_sub = inter[np.ix_(sel_d, sel_g)]
            union = darea[sel_d][:, None] + garea[sel_g][None, :] - inter_sub
            ious = np.where(union > 0, inter_sub / np.maximum(union, 1), 0.0)
            self._stats.setdefault(int(cls), []).append(
                {
                    "scores": scores[sel_d],
                    "darea": darea[sel_d],
                    "garea": garea[sel_g],
                    "ious": ious,
                }
            )

    # ------------------------------------------------------------------
    def _image_class_stats(self, pred, tgt, cls):
        """Per (image, class) quantities shared by every (area, maxDet) pair:
        score-sorted det scores/areas + gt areas + the full IoU matrix.
        Computing the mask IoU ONCE here (instead of per area x maxDet, a 12x
        redundancy) is what makes dataset-scale eval feasible."""
        sel_d = pred["labels"] == cls
        sel_g = tgt["labels"] == cls
        scores = pred["scores"][sel_d]
        order = np.argsort(-scores, kind="mergesort")
        dmasks = pred["masks"][sel_d][order]
        gmasks = tgt["masks"][sel_g]
        darea = (
            dmasks.sum(axis=(1, 2)).astype(np.float64)
            if dmasks.shape[0]
            else np.zeros((0,), np.float64)
        )
        garea = (
            gmasks.sum(axis=(1, 2)).astype(np.float64)
            if gmasks.shape[0]
            else np.zeros((0,), np.float64)
        )
        return {
            "scores": scores[order],
            "darea": darea,
            "garea": garea,
            "ious": mask_iou(dmasks, gmasks),
        }

    def _evaluate_image(self, stats, area_rng, max_det):
        """COCOeval evaluateImg from precomputed stats: returns
        (dt_matches (T, D), dt_scores (D,), dt_ignore (T, D), gt_count)."""
        scores = stats["scores"][:max_det]
        darea_full = stats["darea"][:max_det]
        garea = stats["garea"]
        gt_ignore = (garea < area_rng[0]) | (garea > area_rng[1])
        if scores.size == 0:  # gt-only image: nothing to match or ignore
            nt0 = len(IOU_THRS)
            return (
                np.zeros((nt0, 0), bool),
                scores,
                np.zeros((nt0, 0), bool),
                int((~gt_ignore).sum()),
            )
        # sort gts: non-ignored first (COCO convention)
        gorder = np.argsort(gt_ignore, kind="mergesort")
        gt_ignore = gt_ignore[gorder]
        ious = stats["ious"][:max_det][:, gorder]
        nd, ng = ious.shape
        nt = len(IOU_THRS)
        dt_m = -np.ones((nt, nd), np.int64)
        gt_m = -np.ones((nt, ng), np.int64)
        # Greedy matching is sequential over dets, but all IoU thresholds can be
        # matched simultaneously: per det, pick (vectorized over thresholds) the
        # best still-unmatched gt, preferring non-ignored gts. Tie-break = last
        # index among equals (pycocotools updates on `>=`). 10x fewer
        # interpreted iterations than the per-threshold loop this replaces.
        if nd and ng:
            thr0 = np.minimum(IOU_THRS, 1 - 1e-10)[:, None]  # (nt, 1)
            unmatched = np.ones((nt, ng), bool)
            ign_row = gt_ignore[None, :]
            for di in range(nd):
                eligible = unmatched & (ious[di][None, :] >= thr0)  # (nt, ng)
                reg = eligible & ~ign_row
                use_reg = reg.any(axis=1)
                pool = np.where(use_reg[:, None], reg, eligible)
                has = pool.any(axis=1)
                masked = np.where(pool, ious[di][None, :], -1.0)
                best = ng - 1 - np.argmax(masked[:, ::-1], axis=1)
                rows = np.nonzero(has)[0]
                dt_m[rows, di] = best[rows]
                gt_m[rows, best[rows]] = di
                unmatched[rows, best[rows]] = False
        d_out = (darea_full < area_rng[0]) | (darea_full > area_rng[1])
        dt_ignore = np.zeros((nt, nd), bool)
        for ti in range(nt):
            matched = dt_m[ti] >= 0
            ig = np.zeros(nd, bool)
            ig[matched] = gt_ignore[dt_m[ti][matched]]
            ig[~matched] = d_out[~matched]
            dt_ignore[ti] = ig
        return dt_m >= 0, scores, dt_ignore, int((~gt_ignore).sum())

    def _accumulate_class(self, cls):
        """Returns dict area -> maxdet -> (precision (T, 101), recall (T,))."""
        # Only images where the class appears in preds or targets have stats;
        # all other (image, class) combos contribute nothing to any
        # (area, maxDet) accumulation.
        per_image_stats = self._stats.get(cls, [])
        out = {}
        nt = len(IOU_THRS)
        for aname, arng in AREA_RANGES.items():
            out[aname] = {}
            for max_det in MAX_DETS:
                matches, scores, ignores, npig = [np.zeros((nt, 0), bool)], [np.zeros((0,))], [np.zeros((nt, 0), bool)], 0
                for stats in per_image_stats:
                    m, s, ig, ng = self._evaluate_image(stats, arng, max_det)
                    matches.append(m)
                    scores.append(s)
                    ignores.append(ig)
                    npig += ng
                if npig == 0:
                    out[aname][max_det] = None
                    continue
                scores = np.concatenate(scores)
                order = np.argsort(-scores, kind="mergesort")
                matches = np.concatenate(matches, axis=1)[:, order]
                ignores = np.concatenate(ignores, axis=1)[:, order]
                tps = matches & ~ignores
                fps = ~matches & ~ignores
                tp_sum = np.cumsum(tps, axis=1).astype(np.float64)
                fp_sum = np.cumsum(fps, axis=1).astype(np.float64)
                nt = len(IOU_THRS)
                precision = np.zeros((nt, len(REC_THRS)))
                recall = np.zeros((nt,))
                for ti in range(nt):
                    tp, fp = tp_sum[ti], fp_sum[ti]
                    rc = tp / npig
                    pr = tp / np.maximum(tp + fp, np.finfo(np.float64).eps)
                    recall[ti] = rc[-1] if len(rc) else 0.0
                    # precision envelope
                    pr = pr.tolist()
                    for i in range(len(pr) - 1, 0, -1):
                        if pr[i] > pr[i - 1]:
                            pr[i - 1] = pr[i]
                    inds = np.searchsorted(rc, REC_THRS, side="left")
                    q = np.zeros(len(REC_THRS))
                    for ri, pi in enumerate(inds):
                        if pi < len(pr):
                            q[ri] = pr[pi]
                    precision[ti] = q
                out[aname][max_det] = (precision, recall)
        return out

    def compute(self) -> dict:
        classes = sorted(self._gt_classes)
        per_class = {c: self._accumulate_class(c) for c in classes}

        def mean_ap(area, max_det, iou=None, cls=None):
            vals = []
            for c in classes if cls is None else [cls]:
                acc = per_class[c][area][max_det]
                if acc is None:
                    continue
                p = acc[0]
                if iou is not None:
                    ti = int(np.where(np.isclose(IOU_THRS, iou))[0][0])
                    p = p[ti : ti + 1]
                v = p[p > -1]
                vals.append(np.mean(p) if p.size else np.nan)
            return float(np.mean(vals)) if vals else -1.0

        def mean_ar(area, max_det, cls=None):
            vals = []
            for c in classes if cls is None else [cls]:
                acc = per_class[c][area][max_det]
                if acc is None:
                    continue
                vals.append(np.mean(acc[1]))
            return float(np.mean(vals)) if vals else -1.0

        result = {
            "map": mean_ap("all", 100),
            "map_50": mean_ap("all", 100, iou=0.5),
            "map_75": mean_ap("all", 100, iou=0.75),
            "map_small": mean_ap("small", 100),
            "map_medium": mean_ap("medium", 100),
            "map_large": mean_ap("large", 100),
            "mar_1": mean_ar("all", 1),
            "mar_10": mean_ar("all", 10),
            "mar_100": mean_ar("all", 100),
            "mar_small": mean_ar("small", 100),
            "mar_medium": mean_ar("medium", 100),
            "mar_large": mean_ar("large", 100),
        }
        if self.class_metrics:
            result["classes"] = classes
            result["map_per_class"] = [mean_ap("all", 100, cls=c) for c in classes]
            result["mar_100_per_class"] = [mean_ar("all", 100, cls=c) for c in classes]
        return result
