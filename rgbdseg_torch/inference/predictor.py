"""Single-example predictor (counterpart of
`rgbdseg_tpu/inference/predictor.py::Predictor`; reference: predictor.py:19-69).

`Predictor(cfg, state_dict=None, device=None, seed=0, preprocess=None)` runs on
the CUDA device unless `device` names another; with no CUDA device it raises
rather than fall back to the CPU. Without a `state_dict` the weights are the
port's seeded random initialisation (`utils.weights.init_weights`).

- `predict_example` takes a meta-JSON record of raw frames (PNG paths or uint8
  arrays, `data/registry.py`), ships them to the device as one packed uint8
  buffer (3-9 bytes per pixel: rgb, and the depth and gradient frames the
  layout reads, at the frames' own size) and builds the version's channel
  stack there (`data/device_preprocess.py`), each frame resized from its own
  size to the target by the exact resizer twins. The two layouts built on the
  host only (`map_7channel_g` of 0.0.4, `map_30channel` of 0.2.0, whose record
  lists 10 frames) take the host map function and `predict_pixels`, as in the
  JAX package; the choice is by layout, before any launch.
- `predict_pixels` takes a channel stack (B, H, W, C) already built.
- `predict_and_overlay_files` serves PNG files (the RGB frame, and the depth
  frame for RGB-D versions) through `predict_example` and overlays the
  instances on the RGB at its own size; `predict_and_overlay` is the RGB-only
  path (version 0.0.0) from an array. Both write the overlay as PNG if asked.
"""

from __future__ import annotations

import os
from typing import Mapping, Optional

import numpy as np
import torch

from ..config import ModelConfig, PreprocessConfig
from ..data import registry as R
from ..data.device_preprocess import build_pixels, packed_width, supported
from ..data.image_io import load_rgb, write_png
from ..data.preprocess import output_size, process_image
from ..models.mask2former import Mask2FormerRGBD
from ..utils.weights import init_weights
from ..versions import get as get_version
from .postprocess import _resize_nearest_np, post_process_instance_segmentation
from .visualize import overlay_instances


def pop_device_flag(argv: list[str]) -> tuple[list[str], Optional[str]]:
    """(argv without a `--device NAME` or `--device=NAME` flag, NAME or None):
    the entry scripts take the flag beside the JAX package's argument schema."""
    rest, device, it = [], None, iter(argv)
    for a in it:
        if a == "--device":
            device = next(it, None)
            if device is None:
                raise ValueError("--device needs a value, e.g. --device cpu")
        elif a.startswith("--device="):
            device = a.split("=", 1)[1]
        else:
            rest.append(a)
    return rest, device


def resolve_device(device=None) -> torch.device:
    """`device` as given, else the CUDA device; raises when CUDA is asked for and absent."""
    dev = torch.device(device if device is not None else "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run the port on the CPU")
    return dev


class Predictor:
    def __init__(
        self,
        cfg: ModelConfig,
        state_dict: Optional[Mapping[str, torch.Tensor]] = None,
        device=None,
        seed: int = 0,
        preprocess: Optional[PreprocessConfig] = None,
    ):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.preprocess = preprocess or PreprocessConfig()
        model = Mask2FormerRGBD(cfg)
        if state_dict is None:
            init_weights(model, seed)
        else:
            model.load_state_dict(state_dict, strict=True)
        self.model = model.to(self.device).eval()
        self.last_upload_bytes = 0  # host-to-device bytes of the last request

    @torch.no_grad()
    def _forward(self, pixel_values: torch.Tensor):
        out = self.model(pixel_values)
        return out.class_queries_logits, out.masks_queries_logits

    def _forward_raw(self, frames: list[np.ndarray]):
        """Raw uint8 frames (rgb (H, W, 3) [, depth (h, w, 3) [, gradient]]) -> logits: one
        host-to-device copy of the frames packed end to end, the channels built
        on the device from views of it."""
        packed = torch.from_numpy(np.concatenate([np.ascontiguousarray(f).reshape(-1) for f in frames]))
        self.last_upload_bytes = packed.numel()
        flat = packed.to(self.device)
        views, start = [], 0
        for f in frames:
            views.append(flat[start : start + f.size].reshape(1, *f.shape))
            start += f.size
        views += [None] * (3 - len(views))
        pix = build_pixels(get_version(self.cfg.version).map_fn, views[0], views[1], self.preprocess, views[2])
        return self._forward(pix)

    def predict_example(self, example: dict, threshold: float = 0.5) -> dict:
        """example: meta-JSON record {"image": rgb or [rgb, depth, ...], "annotation":
        optional}; an installed `registry.TRANSFORM` is applied to the colour
        frame (and the annotation) before packing. Returns the post-processed
        instances at the target size `output_size(preprocess)`."""
        map_fn = get_version(self.cfg.version).map_fn
        if not supported(map_fn):
            pix, _, _ = R.MAP_FUNCTIONS[map_fn](example, self.preprocess)
            return self.predict_pixels(pix[None], threshold)[0]
        color, _ = R._color_and_mask(example)
        frames = [color] + [R._depth_rgb(example["image"], i) for i in range(1, packed_width(map_fn) // 3)]
        cls_logits, mask_logits = self._forward_raw(frames)
        return post_process_instance_segmentation(
            cls_logits, mask_logits, threshold=threshold, target_sizes=[output_size(self.preprocess)],
            return_binary_maps=True,
        )[0]

    def predict_pixels(self, pixel_values: np.ndarray, threshold: float = 0.5) -> list[dict]:
        """(B, H, W, C) float channel stack -> per-image post-processed instances."""
        pix = torch.as_tensor(np.ascontiguousarray(pixel_values), dtype=torch.float32)
        self.last_upload_bytes = pix.numel() * pix.element_size()
        pix = pix.to(self.device)
        cls_logits, mask_logits = self._forward(pix)
        target_sizes = [tuple(pixel_values.shape[1:3])] * pixel_values.shape[0]
        return post_process_instance_segmentation(
            cls_logits, mask_logits, threshold=threshold, target_sizes=target_sizes, return_binary_maps=True
        )

    def predict_and_overlay_files(self, image_paths: list, threshold: float = 0.5, save: Optional[str] = None):
        """`image_paths` is [rgb] or [rgb, depth, ...] as a meta-JSON "image"
        entry for this version. Returns (result at the target size, the
        instances overlaid on the RGB at its original size)."""
        example = {"image": image_paths if len(image_paths) > 1 else image_paths[0]}
        res = self.predict_example(example, threshold)
        return res, _overlay(load_rgb(image_paths[0]), res, save)

    def predict_and_overlay(self, image_rgb: np.ndarray, threshold: float = 0.5, save: Optional[str] = None):
        """RGB-only path (version 0.0.0): uint8 (H, W, 3) -> (result at the
        target size, the overlay at (H, W))."""
        pix = process_image(image_rgb, self.preprocess)
        res = self.predict_pixels(pix[None].astype(np.float32), threshold)[0]
        return res, _overlay(image_rgb, res, save)


def _overlay(image_rgb: np.ndarray, res: dict, save: Optional[str]) -> np.ndarray:
    """The result's binary maps, nearest-resized to the image, overlaid on it;
    written to `save` as PNG if given."""
    masks = res["segmentation"]
    if masks.size:
        masks = _resize_nearest_np(masks, image_rgb.shape[:2])
    vis = overlay_instances(image_rgb, masks)
    if save:
        os.makedirs(os.path.dirname(save) or ".", exist_ok=True)
        write_png(save, vis)
    return vis
