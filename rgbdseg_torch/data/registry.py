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

Every layout of the JAX package's registry. Two are built on the host only,
as in the JAX package: `map_7channel_g` (the uint8 cast of a float64 Sobel
magnitude) and `map_30channel` (CSF over 8 augmentation frames, `ops/csf.py`).
Raw-channel quirks of the reference are kept: derived channels (gradients,
normals, gray depth, validity masks) are appended unnormalised, and the
validity masks of gradient images threshold the cv2-resized image at > 50 on
any channel (dataloader.py:163, 246, 374).
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..config import PreprocessConfig
from ..ops.csf import csf_fuse
from ..ops.resize_exact import cv2_resize_linear_u8
from . import image_io
from .depth_features import compute_depth_gradient
from .device_preprocess import build_pixels, packed_width, pil_grayscale_u8
from .preprocess import instance_map_to_binary_masks, output_size, process_image, resize_image


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


def _depth_gray(example_images, idx=1) -> np.ndarray:
    """PIL's ``convert("L")`` of the frame: (H, W) uint8."""
    return pil_grayscale_u8(torch.from_numpy(_depth_rgb(example_images, idx))).numpy()


def _cv2_resize_linear(img: np.ndarray, size_hw) -> np.ndarray:
    return cv2_resize_linear_u8(torch.from_numpy(np.ascontiguousarray(img)), tuple(size_hw),
                                has_channels=img.ndim == 3).numpy()


def _built(map_fn_name: str):
    """The map function of a layout the channel builder builds: its frames
    (`packed_width` // 3 of them) through `build_pixels` on CPU tensors."""
    frames = packed_width(map_fn_name) // 3

    def map_fn(example, cfg: PreprocessConfig):
        color_raw, mask = _color_and_mask(example)
        instance_map, mapping = _mask_and_mapping(mask)
        rgb, depth, grad = (
            torch.from_numpy(np.ascontiguousarray(_depth_rgb(example["image"], i) if i else color_raw))[None]
            if i < frames else None for i in range(3))
        pix = build_pixels(map_fn_name, rgb, depth, cfg, grad)[0].numpy()
        masks, labels = _labels(instance_map, mapping, cfg)
        return pix, masks, labels

    map_fn.__name__ = map_fn.__qualname__ = map_fn_name
    return map_fn


map_3channel = _built("map_3channel")
map_6channel = _built("map_6channel")
# RGB + the gradient-depth image on disk + its > 50 validity mask
map_7channel_tmp = _built("map_7channel_tmp")
# RGB + normalised gradient features of the resized gray depth (raw) + validity
map_7channel_g2 = _built("map_7channel_g2")
# RGB + surface normals of the resized gray depth (raw) + validity
map_7channel_s = _built("map_7channel_s")
# RGB + the raw resized gray depth (version 0.0.7)
map_7channel_s2 = _built("map_7channel_s2")
# RGB + depth + the gradient-depth image on disk + its > 50 validity mask
map_10channel_case1 = _built("map_10channel_case1")
# Final-model (0.4.0) input: RGB + depth + gradient features of the resized
# gray depth + validity mask (reference: dataloader.py:386-425)
map_10channel_case2 = _built("map_10channel_case2")


def map_7channel_g(example, cfg: PreprocessConfig):
    """RGB + the Sobel magnitude of the gray depth cast to uint8 (numpy's cast:
    truncation, and magnitudes above 255 wrap), 3x replicated + > 50 mask."""
    color_raw, mask = _color_and_mask(example)
    instance_map, mapping = _mask_and_mapping(mask)
    color = process_image(color_raw, cfg)
    gm = compute_depth_gradient(_depth_gray(example["image"])).astype(np.uint8)
    grad3 = np.stack([gm, gm, gm], axis=2)
    grad = process_image(grad3, cfg)
    gmask = np.any(_cv2_resize_linear(grad3, output_size(cfg)) > 50, axis=-1).astype(np.float32)[..., None]
    masks, labels = _labels(instance_map, mapping, cfg)
    return np.concatenate([color, grad, gmask], axis=-1), masks, labels


def map_30channel(example, cfg: PreprocessConfig):
    """NYU ultra path: RGB + depth + the CSF fusion of 8 augmentation frames
    (reference: dataloader.py:88-129, nyu_ultra_preprocess :743-759); the
    example's "image" lists 10 frames."""
    color_raw, mask = _color_and_mask(example)
    instance_map, mapping = _mask_and_mapping(mask)
    imgs = [_depth_rgb(example["image"], i) for i in range(len(example["image"]))]
    color = process_image(color_raw, cfg)
    depth = process_image(imgs[1], cfg)
    # uint8 in, uint8 out, as the reference (data_process.py:919 casts back)
    fused = csf_fuse(torch.from_numpy(np.stack(imgs[2:10]))).numpy()
    fused_p = process_image(fused, cfg)
    masks, labels = _labels(instance_map, mapping, cfg)
    # The reference loader emits [color, fused, depth] (dataloader.py:115-120)
    # while the model slices channels 3:6 as "depth" and 6:9 as "fused"
    # (custom_model.py:357-360): its depth encoder sees the CSF-fused image and
    # DSAM the raw depth. Kept as the JAX package keeps it.
    return np.concatenate([color, fused_p, depth], axis=-1), masks, labels


MAP_FUNCTIONS: dict[str, Callable] = {
    "map_3channel": map_3channel,
    "map_6channel": map_6channel,
    "map_7channel_tmp": map_7channel_tmp,
    "map_7channel_g": map_7channel_g,
    "map_7channel_g2": map_7channel_g2,
    "map_7channel_s": map_7channel_s,
    "map_7channel_s2": map_7channel_s2,
    "map_10channel_case1": map_10channel_case1,
    "map_10channel_case2": map_10channel_case2,
    "map_30channel": map_30channel,
}
