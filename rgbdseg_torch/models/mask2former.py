"""Top-level Mask2Former RGB-D model, version-dispatched
(counterpart of `rgbdseg_tpu/models/mask2former.py`).

The version's `FusionSpec` (`versions.py`) decides which fusion modules exist
and how the forward composes them, as in the JAX package:
- a second Swin on the depth channels (`depth_encoder`, `dual_backbone`);
- the DSAM ratio: fixed (`cfg.dsam_default_ratio`), from the depth pyramid
  (`RatioPredictor`) or from the depth image (E-DSAM);
- DSAM on the depth or on the CSF-fused depth channels;
- DGGM v1/v2/v3 fed by the gradient channels, or for 0.0.7 by surface
  normals computed in the forward from the gray depth and the intrinsics
  predictor's (fx, fy, cx, cy). The normals are computed from detached
  intrinsics, as the JAX model stops the gradient at them (the reference
  computes them in host numpy), so no NaN of an invalid pixel enters the
  graph and the intrinsics predictor gets no gradient;
- composed in sequence, DSAM -> DGGM -> FeatureFuser, or for 0.4.0 as the
  sum of DSAM and DGGM over detached backbone maps.
The pixel decoder and the transformer decoder are shared by every version.

`model.train()` is the JAX package's `deterministic=False`: drop path in the
backbones, dropout in the ratio predictor (both drawn from the `generator`
passed to `forward`) and BatchNorm on batch statistics.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from .. import versions as V
from ..config import ModelConfig
from ..ops.normals import surface_normals_intrinsics
from ..utils.trace import span
from .fusion import (
    DepthGradientInjection,
    DepthGradientInjectionResidual,
    DepthGradientInjectionWithMask,
    DSAMCascade,
    EnhancedDepthImageRatioPredictor,
    FeatureFuser,
    IntrinsicsPredictor,
    RatioPredictor,
)
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


# The module that feeds only the detached normals of 0.0.7: no gradient reaches
# it, and the optimizer leaves it alone (`train/optim.py`), as the reference's
# torch AdamW skips its parameters, whose gradients are None.
INTRINSICS_PREDICTOR = "intrinsics_predictor"

_DGGM = {"inject": DepthGradientInjection, "inject_mask": DepthGradientInjectionWithMask,
         "residual": DepthGradientInjectionResidual}


class PixelLevelModule(nn.Module):
    """Backbone + fusion + pixel decoder."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        entry = V.get(cfg.version)
        self.spec, self.fusion = entry.channels, entry.fusion
        fusion = self.fusion
        channels = cfg.backbone.feature_channels
        self.encoder = SwinBackbone(cfg.backbone, in_channels=3)
        if fusion.dual_backbone:
            self.depth_encoder = SwinBackbone(cfg.backbone, in_channels=3)
        if fusion.dsam and fusion.ratio == "backbone":
            self.ratio_predictor = RatioPredictor(channels)
        elif fusion.dsam and fusion.ratio == "enhanced":
            self.ratio_predictor = EnhancedDepthImageRatioPredictor(in_channels=3)
        if fusion.dsam:
            self.dsam_cascade = DSAMCascade(channels, cfg.dsam_num_regions, cfg.dsam_hist_bins, cfg.dsam_prominence)
        if fusion.dggm_source == "normals":
            self.add_module(INTRINSICS_PREDICTOR, IntrinsicsPredictor(in_channels=1))
        if fusion.dggm is not None:
            self.dggm = _DGGM[fusion.dggm](channels)
        if fusion.feature_fuser:
            self.feature_fuser = FeatureFuser(channels)
        self.pixel_decoder = PixelDecoder(cfg, channels)

    def _dsam(self, maps, pixel_values, ratio):
        src = "fused_depth" if self.fusion.dsam_source == "fused_depth" else "depth"
        return self.dsam_cascade(maps, _ch(pixel_values, self.spec, src), ratio)

    def _dggm(self, maps, pixel_values):
        spec, fusion = self.spec, self.fusion
        if fusion.dggm_source == "normals":
            gray = _ch(pixel_values, spec, "gray_depth")  # (B, H, W, 1)
            intrinsics = getattr(self, INTRINSICS_PREDICTOR)(gray)
            with torch.no_grad():
                normals, valid = surface_normals_intrinsics(gray[..., 0], *(t.detach() for t in intrinsics))
            grad, mask = normals, valid[..., None]
        else:
            grad = _ch(pixel_values, spec, "gradient")
            mask = _ch(pixel_values, spec, "gradient_mask") if spec.gradient_mask is not None else None
        if fusion.dggm == "inject":
            return self.dggm(maps, grad)
        return self.dggm(maps, grad, mask)

    def forward(self, pixel_values: torch.Tensor, generator: torch.Generator | None = None):
        cfg, spec, fusion = self.cfg, self.spec, self.fusion
        if pixel_values.shape[-1] != spec.total:
            raise ValueError(f"version {cfg.version} expects {spec.total} channels, got {pixel_values.shape[-1]}")
        with span("model.backbone"):
            color_maps = list(self.encoder(_ch(pixel_values, spec, "rgb"), generator))
            depth_maps = None
            if fusion.dual_backbone:
                depth_maps = list(self.depth_encoder(_ch(pixel_values, spec, "depth"), generator))

        with span("model.fusion"):
            ratio = None
            if fusion.dsam and fusion.ratio == "fixed":
                ratio = torch.full((pixel_values.shape[0],), cfg.dsam_default_ratio, dtype=torch.float32,
                                   device=pixel_values.device)
            elif fusion.dsam and fusion.ratio == "backbone":
                ratio = self.ratio_predictor(depth_maps)[:, 0]
            elif fusion.dsam and fusion.ratio == "enhanced":
                ratio = self.ratio_predictor(_ch(pixel_values, spec, "depth"), generator)[:, 0]

            if fusion.two_branch_sum:
                # 0.4.0: both branches on detached copies of the backbone maps, summed.
                detached = [m.detach() for m in color_maps]
                branch1 = self._dsam(list(detached), pixel_values, ratio)
                branch2 = self._dggm(list(detached), pixel_values)
                fused_maps = [a + b for a, b in zip(branch1, branch2)]
            else:
                fused_maps = color_maps
                if fusion.dsam:
                    fused_maps = self._dsam(fused_maps, pixel_values, ratio)
                if fusion.dggm is not None:
                    fused_maps = self._dggm(fused_maps, pixel_values)
                if fusion.feature_fuser:
                    fused_maps = self.feature_fuser(fused_maps, depth_maps)
            # Keep the pixel decoder in the backbone's dtype (the DSAM masks are f32).
            fused_maps = [m.to(color_maps[0].dtype) for m in fused_maps]
        with span("model.pixel_decoder"):
            return self.pixel_decoder(fused_maps)


def standard_layout(x: torch.Tensor) -> torch.Tensor:
    """`x` with the strides of a fresh contiguous tensor of its shape (a copy
    only where they differ). torch calls a tensor contiguous whatever the
    strides of its size-1 dimensions, but it picks a convolution's memory
    format from all of them: a batch of one with batch stride 0 (numpy's
    `a[None]`) ran the first convolution in NCHW, the same values with a full
    batch stride in NHWC, and cuDNN's kernels for the two sum in different
    orders. The convolutions that read the stack now take NCHW copies of
    their channels (`SwinBackbone`, `EnhancedDepthImageRatioPredictor`), the
    layout numpy's stacks got and the faster one for batch 1 on the H100;
    this keeps every other op from seeing a caller's strides. The depth
    encoder and the intrinsics predictor read NCHW copies too."""
    strides, step = [], 1
    for n in reversed(x.shape):
        strides.append(step)
        step *= n
    if x.stride() == tuple(reversed(strides)):
        return x
    return x.clone(memory_format=torch.contiguous_format)


class Mask2FormerRGBD(nn.Module):
    """Pixel-level module + transformer module; input (B, H, W, C) channels-last,
    any strides (`standard_layout`: the logits depend on its values only)."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        self.pixel_level_module = PixelLevelModule(cfg)
        self.transformer_module = TransformerModule(cfg)

    def forward(self, pixel_values: torch.Tensor, generator: torch.Generator | None = None) -> ModelOutputs:
        mask_features, multi_scale = self.pixel_level_module(standard_layout(pixel_values), generator)
        with span("model.decoder"):
            class_logits, mask_logits = self.transformer_module(multi_scale, mask_features)
        return ModelOutputs(
            class_queries_logits=class_logits[-1],
            masks_queries_logits=mask_logits[-1],
            aux_class_logits=tuple(class_logits[:-1]),
            aux_mask_logits=tuple(mask_logits[:-1]),
        )
