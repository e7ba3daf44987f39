"""The padded batch record (counterpart of `rgbdseg_tpu/data/pipeline.py::Batch`).

Only the record that eval reads is ported; the dataset and its batching are
queued (ROADMAP.md, "Modules to port", item 5).
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
