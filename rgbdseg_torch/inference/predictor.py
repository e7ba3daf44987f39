"""Predictor over a prebuilt channel stack
(counterpart of `rgbdseg_tpu/inference/predictor.py::Predictor.predict_pixels`).

`Predictor(cfg, state_dict=None, device=None)` runs on the CUDA device unless
`device` names another; with no CUDA device it raises rather than fall back to
the CPU. Without a `state_dict` the weights are the port's seeded random
initialisation (`utils.weights.init_weights`). The cv2-based channel builders
of the JAX package are not ported yet: `predict_pixels` takes the version's
channel stack (B, H, W, C) as built by them.
"""

from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch

from ..config import ModelConfig
from ..models.mask2former import Mask2FormerRGBD
from ..utils.weights import init_weights
from .postprocess import post_process_instance_segmentation


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
    ):
        self.cfg = cfg
        self.device = resolve_device(device)
        model = Mask2FormerRGBD(cfg)
        if state_dict is None:
            init_weights(model, seed)
        else:
            model.load_state_dict(state_dict, strict=True)
        self.model = model.to(self.device).eval()

    @torch.no_grad()
    def _forward(self, pixel_values: torch.Tensor):
        out = self.model(pixel_values)
        return out.class_queries_logits, out.masks_queries_logits

    def predict_pixels(self, pixel_values: np.ndarray, threshold: float = 0.5) -> list[dict]:
        """(B, H, W, C) float channel stack -> per-image post-processed instances."""
        pix = torch.as_tensor(np.ascontiguousarray(pixel_values), dtype=torch.float32).to(self.device)
        cls_logits, mask_logits = self._forward(pix)
        target_sizes = [tuple(pixel_values.shape[1:3])] * pixel_values.shape[0]
        return post_process_instance_segmentation(
            cls_logits, mask_logits, threshold=threshold, target_sizes=target_sizes, return_binary_maps=True
        )
