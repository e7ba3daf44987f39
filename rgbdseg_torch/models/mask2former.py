"""Top-level Mask2Former RGB-D model, version-dispatched
(counterpart of `rgbdseg_tpu/models/mask2former.py`).

The port builds version 0.0.0 (RGB, stock Mask2Former) and 0.4.0 (the paper's
final model: E-DSAM ratio + DSAM cascade + DGGM residual, both branches on
detached backbone maps and summed). The other versions raise
NotImplementedError; ROADMAP.md queues them.

`model.train()` is the JAX package's `deterministic=False`: drop path in the
backbone, dropout in the E-DSAM ratio predictor (both drawn from the
`generator` passed to `forward`) and BatchNorm on batch statistics.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from .. import versions as V
from ..config import ModelConfig
from .fusion import DepthGradientInjectionResidual, DSAMCascade, EnhancedDepthImageRatioPredictor
from .pixel_decoder import PixelDecoder
from .swin import SwinBackbone
from .transformer_decoder import TransformerModule


class ModelOutputs(NamedTuple):
    class_queries_logits: torch.Tensor  # (B, Q, num_labels + 1), final layer
    masks_queries_logits: torch.Tensor  # (B, Q, H/4, W/4), final layer
    aux_class_logits: tuple  # per intermediate layer (excluding final)
    aux_mask_logits: tuple


def _ch(x: torch.Tensor, spec: V.ChannelSpec, name: str) -> torch.Tensor:
    return x[..., spec.slice(name)]


class PixelLevelModule(nn.Module):
    """Backbone + fusion + pixel decoder."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        if cfg.version not in V.BUILDABLE:
            raise NotImplementedError(
                f"version {cfg.version} is not ported yet (the port builds {V.BUILDABLE}); "
                "ROADMAP.md, 'Modules to port', queues the other versions"
            )
        self.cfg = cfg
        entry = V.get(cfg.version)
        self.spec, self.fusion = entry.channels, entry.fusion
        channels = cfg.backbone.feature_channels
        self.encoder = SwinBackbone(cfg.backbone, in_channels=3)
        if self.fusion.ratio == "enhanced":
            self.ratio_predictor = EnhancedDepthImageRatioPredictor(in_channels=3)
        if self.fusion.dsam:
            self.dsam_cascade = DSAMCascade(channels, cfg.dsam_num_regions, cfg.dsam_hist_bins, cfg.dsam_prominence)
        if self.fusion.dggm == "residual":
            self.dggm = DepthGradientInjectionResidual(channels)
        self.pixel_decoder = PixelDecoder(cfg, channels)

    def forward(self, pixel_values: torch.Tensor, generator: torch.Generator | None = None):
        cfg, spec, fusion = self.cfg, self.spec, self.fusion
        if pixel_values.shape[-1] != spec.total:
            raise ValueError(f"version {cfg.version} expects {spec.total} channels, got {pixel_values.shape[-1]}")
        color_maps = list(self.encoder(_ch(pixel_values, spec, "rgb"), generator))
        if fusion.two_branch_sum:
            # 0.4.0: both branches on detached copies of the backbone maps, summed.
            ratio = self.ratio_predictor(_ch(pixel_values, spec, "depth"), generator)[:, 0]
            detached = [m.detach() for m in color_maps]
            branch1 = self.dsam_cascade(list(detached), _ch(pixel_values, spec, "depth"), ratio)
            branch2 = self.dggm(
                list(detached), _ch(pixel_values, spec, "gradient"), _ch(pixel_values, spec, "gradient_mask")
            )
            fused_maps = [a + b for a, b in zip(branch1, branch2)]
        else:
            fused_maps = color_maps
        # Keep the pixel decoder in the backbone's dtype (the DSAM masks are f32).
        fused_maps = [m.to(color_maps[0].dtype) for m in fused_maps]
        return self.pixel_decoder(fused_maps)


class Mask2FormerRGBD(nn.Module):
    """Pixel-level module + transformer module; input (B, H, W, C) channels-last."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        self.pixel_level_module = PixelLevelModule(cfg)
        self.transformer_module = TransformerModule(cfg)

    def forward(self, pixel_values: torch.Tensor, generator: torch.Generator | None = None) -> ModelOutputs:
        mask_features, multi_scale = self.pixel_level_module(pixel_values, generator)
        class_logits, mask_logits = self.transformer_module(multi_scale, mask_features)
        return ModelOutputs(
            class_queries_logits=class_logits[-1],
            masks_queries_logits=mask_logits[-1],
            aux_class_logits=tuple(class_logits[:-1]),
            aux_mask_logits=tuple(mask_logits[:-1]),
        )
