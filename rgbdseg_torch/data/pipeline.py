"""The padded batch record and target compaction (counterparts of
`rgbdseg_tpu/data/pipeline.py::Batch` and `::compact_targets`).

The dataset and its batching (`SegmentationDataset`, `build_datasets`) are
queued: ROADMAP.md §1 item 3.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np


@dataclass
class Batch:
    # (B, H, W, C) float32 channel stack, or (B, H, W, packed_width) raw uint8
    # frames that `device_preprocess.build_from_packed` turns into it
    pixel_values: np.ndarray
    mask_labels: np.ndarray  # (B, T, H', W') float32 0/1, padded to T instances
    class_labels: np.ndarray  # (B, T) int
    valid: np.ndarray  # (B, T) bool: which of the T slots are real instances
    # per-example original (pre-resize) image sizes (B, 2) int32, for eval at
    # the original size (reference: predictor.py:692-703)
    orig_sizes: Optional[np.ndarray] = None
    # the masks bit-packed, (B, T, ceil(H'*W'/8)) uint8 (np.packbits over the
    # flattened (H', W')): shipped to the device instead of mask_labels
    mask_labels_packed: Optional[np.ndarray] = None


def compact_targets(
    mask_labels: np.ndarray,
    class_labels: np.ndarray,
    valid: np.ndarray,
    min_bucket: int = 8,
    packed: Optional[np.ndarray] = None,
) -> tuple:
    """Slice padded instance targets to the smallest power-of-two bucket
    (at least `min_bucket`) covering the batch's most real instances.

    The criterion's cost is linear in the padded slot count T, and every
    padded slot pays full price. Valid slots are moved first (a stable
    valid-first permutation, applied only when a valid slot lies past the
    slice point), then every target array is sliced to the bucket. Padding
    rows enter the matcher with a uniform cost and the losses only through
    no-object labels, so the loss is unchanged except that the criterion's
    point coordinates are drawn for T_bucket slots instead of T.

    `packed`, the bit-packed (B, T, N) twin of the masks, is permuted and
    sliced identically and returned as a 4th element.
    """
    valid = np.asarray(valid, bool)
    t = valid.shape[1]
    tmax = int(valid.sum(1).max(initial=0))
    tb = max(1, int(min_bucket))
    while tb < tmax:
        tb *= 2
    tb = min(tb, t)
    if tb >= t:
        out = (mask_labels, class_labels, valid)
        return out + (packed,) if packed is not None else out
    if valid[:, tb:].any():  # valid slots past the slice point: pack them first
        order = np.argsort(~valid, axis=1, kind="stable")
        mask_labels = np.take_along_axis(mask_labels, order[:, :, None, None], axis=1)
        class_labels = np.take_along_axis(class_labels, order, axis=1)
        if packed is not None:
            packed = np.take_along_axis(packed, order[:, :, None], axis=1)
        valid = np.take_along_axis(valid, order, axis=1)
    out = (mask_labels[:, :tb], class_labels[:, :tb], valid[:, :tb])
    return out + (packed[:, :tb],) if packed is not None else out
