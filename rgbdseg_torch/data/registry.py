"""Versioned channel-layout builders, the map-function registry (counterpart of
`rgbdseg_tpu/data/registry.py`, without cv2 and PIL).

Each map function reads an example's frames and its 3-channel annotation mask
and returns (pixel_values (H', W', C) float32, mask_labels (N, H', W') float32,
class_labels (N,) int64) for the version's channel layout
(reference: dataloader.py:23-425). The pixels come from the port's one channel
builder (`data/device_preprocess.py`) run on CPU tensors; the masks and labels
from `data/preprocess.py`.

An example is a meta-JSON record {"image": rgb or [rgb, depth, ...],
"annotation": mask or None}. Each frame is a PNG path (read by
`data/image_io.py` with PIL's conversions) or a uint8 array: an RGB frame
(H, W, 3); a depth frame (H, W) or (H, W, 3). The builder takes the gray
depth as PIL's ``convert("L")`` of the depth frame's RGB, which is the file's
``convert("L")`` for every PNG colour type read. The annotation is a path or a
(H, W, 3) uint8 array in cv2's channel order (reference: data_process.py:111-117,
read with cv2.IMREAD_UNCHANGED): channel 1 holds instance ids, channel 2
semantic ids, and the (instance, semantic) pairs of channels [1:] define
instance_id_to_semantic_id.

Ported layouts: `map_3channel` (0.0.0) and `map_10channel_case2` (0.4.0); the
others come with their versions (ROADMAP.md).
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..config import PreprocessConfig
from . import image_io
from .device_preprocess import build_pixels
from .preprocess import instance_map_to_binary_masks, output_size, resize_image


def _load_mask(annotation) -> np.ndarray:
    if isinstance(annotation, np.ndarray):
        return annotation
    return image_io.load_unchanged(annotation)


def _mask_and_mapping(mask: np.ndarray):
    semantic_and_instance = mask[..., 1:]
    instance_map = semantic_and_instance[..., 0]
    if mask.dtype == np.uint8:
        # the (instance, semantic) pairs as 16-bit keys: the nonzero bins of a
        # count list them in np.unique(..., axis=0)'s lexicographic order, in
        # ~1 ms where the row sort takes ~280 ms for a 480x640 mask
        key = (instance_map.astype(np.int32) << 8) | semantic_and_instance[..., 1]
        present = np.flatnonzero(np.bincount(key.ravel(), minlength=1 << 16))
        pairs = np.stack([present >> 8, present & 0xFF], axis=1)
    else:
        pairs = np.unique(semantic_and_instance.reshape(-1, 2), axis=0)
    mapping = {int(i): int(s) for i, s in pairs}
    return instance_map, mapping


def _labels(instance_map, mapping, cfg: PreprocessConfig):
    resized = resize_image(instance_map, output_size(cfg), nearest=True)
    return instance_map_to_binary_masks(resized, mapping, cfg)


def _frame(example_images, idx: int):
    if isinstance(example_images, (list, tuple)):
        return example_images[idx]
    if idx:
        raise ValueError("this layout needs a depth frame: give the example's image as [rgb, depth]")
    return example_images


def _rgb(example_images) -> np.ndarray:
    img = _frame(example_images, 0)
    return image_io.load_rgb(img) if isinstance(img, str) else np.asarray(img)


def _depth_rgb(example_images, idx=1) -> np.ndarray:
    """The depth frame as PIL's ``convert("RGB")`` gives it: (H, W, 3) uint8."""
    img = _frame(example_images, idx)
    if isinstance(img, str):
        return image_io.load_rgb(img)
    img = np.asarray(img)
    return np.repeat(img[..., None], 3, axis=-1) if img.ndim == 2 else img


# Augmentation extension point (reference: dataloader.py:19 `no_augment_and_
# transform = A.Compose([A.NoOp()])`, applied jointly to the colour image and
# the 3-channel annotation mask in every map function). The default is a NoOp,
# as in the reference; install an albumentations-style callable with
# set_transform(). Depth and derived channels are built from the untransformed
# frames (the reference's limitation too).
TRANSFORM = None


def set_transform(fn) -> None:
    """fn(image=rgb_uint8, mask=mask3ch) -> {"image": ..., "mask": ...}, or
    None for the NoOp."""
    global TRANSFORM
    TRANSFORM = fn


def _color_and_mask(example) -> tuple[np.ndarray, np.ndarray]:
    color = _rgb(example["image"])
    if example.get("annotation") is None:
        # inference: no annotation; an all-zero mask gives one background
        # instance, the pixel channels build the same
        mask = np.zeros(color.shape[:2] + (3,), np.uint8)
    else:
        mask = _load_mask(example["annotation"])
    if TRANSFORM is not None:
        out = TRANSFORM(image=color, mask=mask)
        color, mask = np.asarray(out["image"]), np.asarray(out["mask"])
    return color, mask


def _pixels(map_fn_name: str, color: np.ndarray, depth: np.ndarray | None, cfg: PreprocessConfig) -> np.ndarray:
    """One example's channel stack from the channel builder, on CPU tensors."""
    def t(x):
        return None if x is None else torch.from_numpy(np.ascontiguousarray(x))[None]

    return build_pixels(map_fn_name, t(color), t(depth), cfg)[0].numpy()


def map_3channel(example, cfg: PreprocessConfig):
    color_raw, mask = _color_and_mask(example)
    instance_map, mapping = _mask_and_mapping(mask)
    pix = _pixels("map_3channel", color_raw, None, cfg)
    masks, labels = _labels(instance_map, mapping, cfg)
    return pix, masks, labels


def map_10channel_case2(example, cfg: PreprocessConfig):
    """Final-model (0.4.0) input: RGB + depth + gradient features of the resized
    gray depth + validity mask (reference: dataloader.py:386-425)."""
    color_raw, mask = _color_and_mask(example)
    instance_map, mapping = _mask_and_mapping(mask)
    pix = _pixels("map_10channel_case2", color_raw, _depth_rgb(example["image"], 1), cfg)
    masks, labels = _labels(instance_map, mapping, cfg)
    return pix, masks, labels


MAP_FUNCTIONS: dict[str, Callable] = {
    "map_3channel": map_3channel,
    "map_10channel_case2": map_10channel_case2,
}
