"""Image and segmentation preprocessing with the reference's
Mask2FormerImageProcessor semantics (counterpart of
`rgbdseg_tpu/data/preprocess.py`, without PIL):

- images: PIL BILINEAR resize to (ceil(H/32)*32, ceil(W/32)*32), rescale 1/255,
  ImageNet normalise;
- segmentation maps: PIL NEAREST resize;
- instance maps -> per-instance binary masks and semantic class labels through
  the instance_id_to_semantic_id mapping, honouring ignore_index and
  reduce_labels (HF convert_segmentation_map_to_binary_masks).

The resizes are the exact twins of `ops/resize_exact.py`, run here on CPU
tensors; the arrays in and out are numpy.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..config import PreprocessConfig
from ..ops.resize_exact import pil_resize_nearest, pil_resize_u8


def output_size(cfg: PreprocessConfig) -> tuple[int, int]:
    d = cfg.size_divisor
    h = int(math.ceil(cfg.height / d) * d) if d else cfg.height
    w = int(math.ceil(cfg.width / d) * d) if d else cfg.width
    return h, w


def resize_image(image: np.ndarray, size_hw: tuple[int, int], nearest: bool = False) -> np.ndarray:
    """PIL resize of an (H, W) or (H, W, C) image: NEAREST of any integer map,
    BILINEAR of uint8 (the builders' only bilinear input)."""
    if image.shape[:2] == tuple(size_hw):
        return image
    x = torch.from_numpy(np.ascontiguousarray(image))
    if nearest:
        return pil_resize_nearest(x, size_hw, has_channels=image.ndim == 3).numpy()
    if image.dtype != np.uint8:
        raise TypeError(f"bilinear resize takes uint8 images, got {image.dtype}")
    return pil_resize_u8(x, size_hw, has_channels=image.ndim == 3).numpy()


def normalize_image(image: np.ndarray, cfg: PreprocessConfig) -> np.ndarray:
    x = image.astype(np.float32)
    if cfg.do_rescale:
        x = x * np.float32(cfg.rescale_factor)
    if cfg.do_normalize:
        x = (x - np.asarray(cfg.image_mean, np.float32)) / np.asarray(cfg.image_std, np.float32)
    return x


def process_image(image: np.ndarray, cfg: PreprocessConfig) -> np.ndarray:
    """uint8 (H, W, 3) -> float32 (H', W', 3), resized, rescaled and normalised."""
    if cfg.do_resize:
        image = resize_image(image, output_size(cfg))
    return normalize_image(image, cfg)


def instance_map_to_binary_masks(
    instance_map: np.ndarray,
    instance_id_to_semantic_id: dict[int, int],
    cfg: PreprocessConfig,
) -> tuple[np.ndarray, np.ndarray]:
    """HF convert_segmentation_map_to_binary_masks semantics.

    Returns (masks (N, H, W) float32, class_labels (N,) int64). With
    do_reduce_labels, id 0 -> ignore and other semantic ids shift by -1.
    """
    seg = instance_map
    if cfg.do_reduce_labels:
        seg = np.where(seg == 0, 255, seg - 1)
    all_labels = np.unique(seg)
    if cfg.ignore_index is not None:
        all_labels = all_labels[all_labels != cfg.ignore_index]
    masks = [(seg == i) for i in all_labels]
    if cfg.do_reduce_labels:
        labels = [instance_id_to_semantic_id[int(i) + 1] - 1 for i in all_labels]
    else:
        labels = [instance_id_to_semantic_id[int(i)] for i in all_labels]
    if not masks:
        h, w = seg.shape
        return np.zeros((0, h, w), np.float32), np.zeros((0,), np.int64)
    return np.stack(masks).astype(np.float32), np.asarray(labels, np.int64)


def process_example(
    image: np.ndarray,
    instance_map: np.ndarray,
    instance_id_to_semantic_id: dict[int, int],
    cfg: PreprocessConfig,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(pixel_values (H', W', 3), mask_labels (N, H', W'), class_labels (N,))."""
    pix = process_image(image, cfg)
    if cfg.do_resize:
        instance_map = resize_image(instance_map, output_size(cfg), nearest=True)
    masks, labels = instance_map_to_binary_masks(instance_map, instance_id_to_semantic_id, cfg)
    return pix, masks, labels
