"""Depth-fusion modules of version 0.4.0
(counterpart of `rgbdseg_tpu/models/fusion.py`): the E-DSAM ratio predictor,
the DSAM module and cascade, and the DGGM residual.

Module boundaries are channels-last (B, H, W, C) like the JAX package; the
convolutions run NCHW inside. BatchNorm is torch's BatchNorm2d (eps 1e-5): in
eval mode it normalises with the running statistics; in train mode with the
batch's (biased variance) and it updates the running statistics with momentum
0.1 and the unbiased variance. That is what the JAX `TorchBatchNorm`
reproduces. The JAX package's folding of BN into the conv weights is a TPU
speed trick that the port does not need. In train mode the ratio predictor's
MLP applies dropout 0.3 after fc0 and 0.2 after fc1, with masks from the
caller's generator.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.depth_decomp import dsam_region_masks, dsam_region_masks_pooled
from ..ops.image import to_grayscale
from ..ops.resize import adaptive_avg_pool2d, adaptive_max_pool2d, resize_bilinear, resize_nearest
from .stochastic import Dropout


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


class EnhancedDepthImageRatioPredictor(nn.Module):
    """E-DSAM ratio predictor (reference custom_model.py:1363-1487): 3/5/7 convs
    sharing one 192-channel BN, a fusion conv, channel attention, a conv/pool
    tower and an MLP mapped to [out_min, out_max]."""

    def __init__(self, in_channels: int = 3, out_min: float = 0.01, out_max: float = 0.5):
        super().__init__()
        self.out_min, self.out_max = out_min, out_max
        for i, k in enumerate((3, 5, 7)):
            self.add_module(f"scale{i}_conv", nn.Conv2d(in_channels, 64, k, padding=k // 2))
        self.scales_bn = nn.BatchNorm2d(192, eps=1e-5)
        self.fusion_conv = nn.Conv2d(192, 128, 1)
        self.fusion_bn = nn.BatchNorm2d(128, eps=1e-5)
        self.attn_conv0 = nn.Conv2d(128, 64, 1)
        self.attn_conv1 = nn.Conv2d(64, 128, 1)
        self.extract_conv0 = nn.Conv2d(128, 256, 3, padding=1)
        self.extract_bn0 = nn.BatchNorm2d(256, eps=1e-5)
        self.extract_conv1 = nn.Conv2d(256, 512, 3, padding=1)
        self.extract_bn1 = nn.BatchNorm2d(512, eps=1e-5)
        self.fc0 = nn.Linear(512, 128)
        self.dropout0 = Dropout(0.3)
        self.fc1 = nn.Linear(128, 64)
        self.dropout1 = Dropout(0.2)
        self.fc2 = nn.Linear(64, 32)
        self.fc3 = nn.Linear(32, 1)

    def forward(self, depth: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        x = _nchw(depth)
        x = torch.cat([self.scale0_conv(x), self.scale1_conv(x), self.scale2_conv(x)], dim=1)
        x = F.relu(self.scales_bn(x))
        x = F.relu(self.fusion_bn(self.fusion_conv(x)))
        a = torch.sigmoid(self.attn_conv1(F.relu(self.attn_conv0(x))))
        x = x * a
        x = F.relu(self.extract_bn0(self.extract_conv0(x)))
        x = _nchw(adaptive_avg_pool2d(_nhwc(x), (4, 4)))
        x = F.relu(self.extract_bn1(self.extract_conv1(x)))
        x = x.mean(dim=(2, 3))
        x = self.dropout0(F.relu(self.fc0(x)), generator)
        x = self.dropout1(F.relu(self.fc1(x)), generator)
        x = F.relu(self.fc2(x))
        raw = self.fc3(x)
        return self.out_min + (self.out_max - self.out_min) * torch.sigmoid(raw)


class DSAModule(nn.Module):
    """Depth-Sensitive Attention Module over precomputed region masks.

    With in != out channels the T+1 region convs are 3x3 stride 2 and the
    residual projection is a bias-free 3x3 stride 2; otherwise all convs are
    1x1 and the residual is the identity."""

    def __init__(self, in_channels: int, out_channels: int, num_regions: int = 3):
        super().__init__()
        self.num_regions = num_regions
        self.strided = in_channels != out_channels
        for i in range(num_regions + 1):
            if self.strided:
                conv = nn.Conv2d(in_channels, out_channels, 3, stride=2, padding=1)
            else:
                conv = nn.Conv2d(in_channels, out_channels, 1)
            self.add_module(f"conv{i}", conv)
        if self.strided:
            self.rgb_projection = nn.Conv2d(in_channels, out_channels, 3, stride=2, padding=1, bias=False)

    def forward(self, features, masks, active):
        # features (B, H, W, Cin); masks (B, H, W, T+1) already pooled to H, W; active (B, T+1)
        f = _nchw(features)
        m = _nchw(masks).to(f.dtype)
        enhanced = None
        for i in range(self.num_regions + 1):
            y = getattr(self, f"conv{i}")(f * m[:, i : i + 1])
            y = y * active[:, i].to(y.dtype)[:, None, None, None]
            enhanced = y if enhanced is None else enhanced + y
        proj = self.rgb_projection(f) if self.strided else f
        return _nhwc(enhanced + proj)


class DSAMCascade(nn.Module):
    """The 3-stage DSAM cascade: dsam_k maps scale k (C_k) to C_{k+1} at half
    resolution and adds into scale k+1. Region masks are computed once at stage
    0's resolution and chain-max-pooled down the pyramid when every size
    divides (`chain_ok`), else from the full-resolution masks."""

    def __init__(self, channels: Sequence[int] = (96, 192, 384, 768), num_regions: int = 3,
                 hist_bins: int = 512, prominence: float = 0.01):
        super().__init__()
        self.num_regions, self.hist_bins, self.prominence = num_regions, hist_bins, prominence
        for k in range(3):
            self.add_module(f"dsam{k}", DSAModule(channels[k], channels[k + 1], num_regions))

    def forward(self, color_maps, depth_3ch, ratio):
        gray = to_grayscale(depth_3ch)
        maps = list(color_maps)
        th0, tw0 = maps[0].shape[1:3]
        sizes = [tuple(m.shape[1:3]) for m in maps[:3]]
        chain_ok = (
            gray.shape[1] % th0 == 0
            and gray.shape[2] % tw0 == 0
            and all(
                sizes[k][0] % sizes[k + 1][0] == 0 and sizes[k][1] % sizes[k + 1][1] == 0 for k in range(2)
            )
        )
        opts = dict(num_modes=self.num_regions, bins=self.hist_bins, prominence_frac=self.prominence)
        if chain_ok:
            mk, active = dsam_region_masks_pooled(gray, ratio, (th0, tw0), **opts)
            mk_full = mk
        else:
            masks, active = dsam_region_masks(gray, ratio, **opts)
            mk_full = masks.permute(0, 2, 3, 1)
            mk = mk_full
        for k in range(3):
            th, tw = maps[k].shape[1:3]
            if tuple(mk.shape[1:3]) != (th, tw):
                src = mk if (mk.shape[1] % th == 0 and mk.shape[2] % tw == 0) else mk_full
                mk = adaptive_max_pool2d(src, (th, tw))
            maps[k + 1] = maps[k + 1] + getattr(self, f"dsam{k}")(maps[k], mk, active)
        return maps


class DepthGradientInjectionResidual(nn.Module):
    """DGGM v3: gated (gradient x validity mask) -> 1x1 conv -> ReLU, added per scale."""

    def __init__(self, channels: Sequence[int], grad_channels: int = 3):
        super().__init__()
        for i, c in enumerate(channels):
            self.add_module(f"enhance{i}", nn.Conv2d(grad_channels, c, 1))

    def forward(self, color_maps, gradient, mask):
        out = []
        for i, c in enumerate(color_maps):
            size = tuple(c.shape[1:3])
            gated = resize_bilinear(gradient, size) * resize_nearest(mask, size)
            enh = F.relu(getattr(self, f"enhance{i}")(_nchw(gated)))
            out.append(c + _nhwc(enh))
        return out
