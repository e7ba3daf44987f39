"""Streaming evaluator: instance post-processing and per-class mask mAP
(counterpart of `rgbdseg_tpu/train/evaluator.py`).

Parity target: the reference Evaluator (model_essential_part.py:31-157):
- predictions post-processed with threshold 0.0 and binary maps, at the GT
  masks' size (or each example's original size);
- ground truth from the batch's padded (mask_labels, class_labels, valid);
- per-class map/mar flattened into `map_<classname>` keys;
- the metric resets after each compute.

Two paths give the same metric inputs. The device-stats path (taken when every
image of the batch evaluates at one size and RGBDSEG_EVAL_DEVICE_STATS is not
"0") computes IoU and area counts where the logits are
(`inference.postprocess.eval_stats`) and moves O(Q*T) numbers to the host,
through a queue of RGBDSEG_EVAL_PIPELINE_DEPTH (default 2) batches whose copies
are started at dispatch and read later. The host path moves the kept binary
masks and counts on the host (`MeanAveragePrecision.update`).

`compute` adds its host seconds and the images it scored to the counters
`map.compute_s` and `map.images` (`utils/trace.py`); `update`, the drain of a
deferred batch, `flush` and `compute` are the spans `eval.update`,
`eval.drain`, `eval.flush` and `eval.compute`.
"""

from __future__ import annotations

import collections
import os
import time

import numpy as np
import torch

from ..inference.postprocess import _resize_nearest, eval_stats, post_process_instance_segmentation
from ..utils.trace import counters, span
from .map_metric import MeanAveragePrecision

MAP = counters("map", ("compute_s", "images"))


class Evaluator:
    def __init__(self, id2label: dict[int, str], threshold: float = 0.0, eval_at_original_size: bool = False):
        """`eval_at_original_size=False` evaluates at the GT masks' (preprocessed)
        size, as the reference's in-training evaluator does; True evaluates
        predictions and GT at each example's `Batch.orig_sizes`."""
        self.id2label = id2label
        self.threshold = threshold
        self.eval_at_original_size = eval_at_original_size
        self.metric = MeanAveragePrecision(class_metrics=True)
        # Deferred-drain queue of the device-stats path: (host copies in
        # flight, their completion event, GT labels, GT validity). The depth is
        # read once, here (0 = drain at once).
        self._pending: collections.deque = collections.deque()
        self._pending_depth = max(0, int(os.environ.get("RGBDSEG_EVAL_PIPELINE_DEPTH", "2")))
        self._images = 0  # images fed to the metric since its last reset

    @span("eval.update")
    def update(self, class_logits: torch.Tensor, mask_logits: torch.Tensor, batch, target_sizes=None):
        """One batch: logits (B, Q, L+1) and (B, Q, h, w) on any device, and its
        `data.pipeline.Batch` (numpy)."""
        b = batch.pixel_values.shape[0]
        if target_sizes is None:
            if self.eval_at_original_size and batch.orig_sizes is not None:
                target_sizes = [tuple(int(v) for v in s) for s in batch.orig_sizes]
            else:
                # the GT mask shape is the reference's target size, also when the
                # batch carries raw source-size uint8 frames
                target_sizes = [tuple(batch.mask_labels.shape[2:4])] * b
        if len(set(map(tuple, target_sizes))) == 1 and os.environ.get("RGBDSEG_EVAL_DEVICE_STATS", "1") == "1":
            return self._update_device_stats(class_logits, mask_logits, batch, tuple(target_sizes[0]))
        # The host path: drain the deferred device-stats updates first, so the
        # metric sees the batches in order (score ties break by insertion order).
        self.flush()
        results = post_process_instance_segmentation(
            class_logits, mask_logits, threshold=self.threshold, target_sizes=target_sizes, return_binary_maps=True
        )
        preds, targets = [], []
        for i, res in enumerate(results):
            info = res["segments_info"]
            preds.append({
                "scores": np.asarray([s["score"] for s in info], np.float32),
                "labels": np.asarray([s["label_id"] for s in info], np.int64),
                "masks": res["segmentation"].astype(bool),
            })
            valid = np.asarray(batch.valid[i], bool)
            gt_masks = torch.from_numpy(np.asarray(batch.mask_labels[i])[valid].astype(bool))
            targets.append({
                "labels": np.asarray(batch.class_labels[i])[valid].astype(np.int64),
                "masks": _resize_nearest(gt_masks, target_sizes[i]).numpy(),
            })
        self.metric.update(preds, targets)
        self._images += len(preds)

    def _dispatch_stats(self, class_logits, mask_logits, gt_packed, valid, target_hw, gt_hw):
        """Queue `eval_stats` on the logits' device and start the copies of its
        outputs to the host; returns (host tensors, completion event or None)."""
        dev = class_logits.device
        outs = eval_stats(
            class_logits, mask_logits, torch.from_numpy(np.ascontiguousarray(gt_packed)).to(dev),
            torch.from_numpy(np.asarray(valid, bool)).to(dev), target_hw, gt_hw,
        )
        if dev.type != "cuda":
            return outs, None
        host = tuple(x.to("cpu", non_blocking=True) for x in outs)
        done = torch.cuda.Event()
        done.record()
        return host, done

    @staticmethod
    @span("eval.drain")
    def _materialize_stats(outs, done=None):
        if done is not None:
            done.synchronize()
        # bfloat16 scores (of a model cast whole to bfloat16) widen exactly: numpy has no bfloat16
        scores, labels, darea, garea, inter = (x.float().numpy() if x.dtype == torch.bfloat16 else x.numpy()
                                               for x in outs)
        # The host path reads scores from segments_info, rounded to 6 decimals
        # (the reference's post-processing): round here too, so both paths
        # feed the metric the same numbers.
        return np.round(scores.astype(np.float64), 6), labels, darea, garea, inter

    def device_stats_arrays(self, class_logits, mask_logits, gt_packed, valid, target_hw, gt_hw):
        """`eval_stats` of (possibly one rank's rows of) logits and bit-packed GT,
        read back to the host at once: the metric inputs of those rows as
        numpy arrays. Synchronous, for the several-process eval
        (`train/trainer.py::_update_gathered`), which gathers them now."""
        return self._materialize_stats(
            *self._dispatch_stats(class_logits, mask_logits, gt_packed, valid, target_hw, gt_hw))

    def update_from_stats(self, stats, gt_labels, gt_valid):
        """Per-image metric updates from the statistics' arrays."""
        scores, labels, darea, garea, inter = stats
        gt_labels = np.asarray(gt_labels)
        gt_valid = np.asarray(gt_valid, bool)
        for i in range(len(scores)):
            cand = (scores[i] >= self.threshold) & (darea[i] > 0)
            gv = gt_valid[i]
            self.metric.update_precomputed(
                scores[i][cand], labels[i][cand], darea[i][cand], inter[i][cand][:, gv], gt_labels[i][gv], garea[i][gv]
            )
        self._images += len(scores)

    def _update_device_stats(self, class_logits, mask_logits, batch, target_hw):
        b, t, gh, gw = np.shape(batch.mask_labels)
        gt_packed = batch.mask_labels_packed
        if gt_packed is None:
            gt_packed = np.packbits(np.asarray(batch.mask_labels).astype(bool).reshape(b, t, -1), axis=-1)
        outs = self._dispatch_stats(class_logits, mask_logits, gt_packed, batch.valid, target_hw, (gh, gw))
        self._pending.append((outs, np.asarray(batch.class_labels), np.asarray(batch.valid, bool)))
        while len(self._pending) > self._pending_depth:
            self._drain_one()

    def _drain_one(self):
        (outs, done), gt_labels, gt_valid = self._pending.popleft()
        self.update_from_stats(self._materialize_stats(outs, done), gt_labels, gt_valid)

    @span("eval.flush")
    def flush(self):
        """Drain every deferred device-stats update into the metric."""
        while self._pending:
            self._drain_one()

    def reset(self):
        """Discard deferred updates and the accumulated metric state."""
        self._pending.clear()
        self.metric.reset()
        self._images = 0

    @span("eval.compute")
    def compute(self, prefix: str = "") -> dict[str, float]:
        t0 = time.perf_counter()
        self.flush()
        out = self.metric.compute()
        metrics: dict[str, float] = {}
        classes = out.pop("classes", [])
        map_pc = out.pop("map_per_class", [])
        mar_pc = out.pop("mar_100_per_class", [])
        for k, v in out.items():
            metrics[prefix + k] = float(v)
        for c, m, r in zip(classes, map_pc, mar_pc):
            name = self.id2label.get(int(c), str(int(c)))
            metrics[f"{prefix}map_{name}"] = float(m)
            metrics[f"{prefix}mar_100_{name}"] = float(r)
        self.metric.reset()
        MAP["compute_s"] += time.perf_counter() - t0
        MAP["images"] += self._images
        self._images = 0
        return metrics
