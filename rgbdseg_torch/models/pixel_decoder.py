"""Pixel decoder: multi-scale deformable-attention encoder + FPN
(counterpart of `rgbdseg_tpu/models/pixel_decoder.py`).

4 channels-last backbone maps -> (mask_features at stride 4, three maps at
strides 32/16/8). The sampling of all levels goes through kernel K1
(`ops.kernels.deformable.deform_sample_levels`), one launch per encoder
layer. LayerNorm and GroupNorm use flax's default eps 1e-6, not torch's 1e-5.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..config import ModelConfig
from ..ops.kernels.deformable import deform_sample_levels
from ..ops.resize import resize_bilinear
from .layers import Conv2d, GroupNorm, LayerNorm, Linear
from .position import sine_position_embedding

FLAX_EPS = 1e-6


def offset_bias_grid(num_heads: int, n_levels: int, n_points: int) -> np.ndarray:
    """Deformable-DETR sampling-offset bias: per-head unit directions scaled by point index."""
    thetas = np.arange(num_heads, dtype=np.float64) * (2.0 * np.pi / num_heads)
    grid = np.stack([np.cos(thetas), np.sin(thetas)], -1)
    grid = grid / np.abs(grid).max(-1, keepdims=True)
    grid = np.tile(grid[:, None, None, :], (1, n_levels, n_points, 1))
    for i in range(n_points):
        grid[:, :, i, :] *= i + 1
    return grid.reshape(-1).astype(np.float32)


def sampling_locations(reference_points, offsets, spatial_shapes) -> torch.Tensor:
    """(B, L, nh, nl, P, 2) normalized (x, y): each query's reference point
    (B, L, nl, 2) plus its pixel offsets (B, L, nh, nl, P, 2) over the level's
    (w, h). In f32: pixel coordinates reach O(100). The bits are the JAX
    package's under jit on the CPU, where XLA computes ref + offset * (1 / w) as
    one fused multiply-add with the float32 reciprocal; here the product is
    exact in float64 and the sum is rounded once more to float32, the same on
    every device (see `reference_points_for_shapes` for why the bits matter)."""
    inv = torch.tensor([[_f32_reciprocal(w), _f32_reciprocal(h)] for (h, w) in spatial_shapes],
                       dtype=torch.float64, device=offsets.device)
    locations = (
        reference_points.double()[:, :, None, :, None, :]
        + offsets.double() * inv[None, None, None, :, None, :]
    )
    return locations.float()


class DeformableAttention(nn.Module):
    """Multi-scale deformable self-attention (n_levels levels, n_points points)."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        d, nh = cfg.feature_size, cfg.num_attention_heads
        nl, npts = cfg.num_feature_levels, cfg.deformable_points
        self.nh, self.nl, self.npts = nh, nl, npts
        self.value_proj = Linear(d, d)
        self.sampling_offsets = Linear(d, nh * nl * npts * 2)
        self.attention_weights = Linear(d, nh * nl * npts)
        self.output_proj = Linear(d, d)

    def forward(self, hidden_states, position_embeddings, reference_points, spatial_shapes):
        nh, npts = self.nh, self.npts
        nl = len(spatial_shapes)
        b, l, d = hidden_states.shape
        hd = d // nh
        with_pos = hidden_states + position_embeddings
        value = self.value_proj(hidden_states).reshape(b, l, nh, hd)
        offsets = self.sampling_offsets(with_pos).reshape(b, l, nh, nl, npts, 2)
        weights = torch.softmax(self.attention_weights(with_pos).reshape(b, l, nh, nl * npts), dim=-1)
        weights = weights.reshape(b, l, nh, nl, npts)

        locations = sampling_locations(reference_points, offsets, spatial_shapes)
        out = deform_sample_levels(value, spatial_shapes, locations, weights.float())
        return self.output_proj(out.to(hidden_states.dtype))


class EncoderLayer(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        d = cfg.feature_size
        self.self_attn = DeformableAttention(cfg)
        self.self_attn_layer_norm = LayerNorm(d, eps=FLAX_EPS)
        self.fc1 = Linear(d, cfg.encoder_feedforward_dim)
        self.fc2 = Linear(cfg.encoder_feedforward_dim, d)
        self.final_layer_norm = LayerNorm(d, eps=FLAX_EPS)

    def forward(self, x, pos, reference_points, spatial_shapes):
        x = self.self_attn_layer_norm(x + self.self_attn(x, pos, reference_points, spatial_shapes))
        return self.final_layer_norm(x + self.fc2(F.relu(self.fc1(x))))


def reference_points_for_shapes(spatial_shapes, device=None) -> torch.Tensor:
    """(L_total, 2) normalized (x, y) half-pixel reference points, (i + 0.5) times
    the float32 reciprocal of the level's size: the JAX package's bits (XLA turns
    its division by a constant into that product), the same on every device. A
    division would not be: the CPU divides, CUDA multiplies by the reciprocal, and
    they part by an ulp at about 40% of the 480x640 points. Many seeded samples
    sit on exact integers, where K1's gradient (the tent's subgradient) jumps, so
    that ulp changed the sampling offsets' gradient by half its size."""
    pts = []
    for h, w in spatial_shapes:
        ry = (torch.arange(h, dtype=torch.float32, device=device) + 0.5) * _f32_reciprocal(h)
        rx = (torch.arange(w, dtype=torch.float32, device=device) + 0.5) * _f32_reciprocal(w)
        gy, gx = torch.meshgrid(ry, rx, indexing="ij")
        pts.append(torch.stack([gx.reshape(-1), gy.reshape(-1)], dim=-1))
    return torch.cat(pts, dim=0)


def _f32_reciprocal(n: int) -> float:
    """1 / n rounded to float32 (and exact as a Python float)."""
    return float(np.float32(1.0) / np.float32(n))


def initial_locations(spatial_shapes, nh: int, npts: int, device=None) -> torch.Tensor:
    """The sampling locations (1, L_total, nh, nl, P, 2) of a freshly initialised
    layer (zero offset kernel, `offset_bias_grid` bias): every query samples 1..P
    pixels from its reference point along its head's direction, at every level."""
    nl = len(spatial_shapes)
    ref = reference_points_for_shapes(spatial_shapes, device)[None, :, None, :].expand(1, -1, nl, 2)
    off = torch.from_numpy(offset_bias_grid(nh, nl, npts)).to(device).reshape(1, 1, nh, nl, npts, 2)
    return sampling_locations(ref, off.expand(1, ref.shape[1], nh, nl, npts, 2), spatial_shapes)


class PixelDecoder(nn.Module):
    """features (4 channels-last maps, low -> high stride) -> (mask_features, 3 multi-scale maps)."""

    def __init__(self, cfg: ModelConfig, in_channels: tuple[int, ...]):
        super().__init__()
        self.cfg = cfg
        d, nl = cfg.feature_size, cfg.num_feature_levels
        self.level_embed = nn.Parameter(torch.zeros(nl, d))
        for i, c in enumerate(in_channels[::-1][:nl]):
            self.add_module(f"input_proj{i}_conv", Conv2d(c, d, 1))
            self.add_module(f"input_proj{i}_norm", GroupNorm(32, d, eps=FLAX_EPS))
        for li in range(cfg.encoder_layers):
            self.add_module(f"layer{li}", EncoderLayer(cfg))
        stride = min(cfg.feature_strides[-nl:])
        self.num_fpn = int(np.log2(stride) - np.log2(cfg.common_stride))
        for i, c in enumerate(list(in_channels[: self.num_fpn])[::-1]):
            self.add_module(f"adapter{i}_conv", Conv2d(c, d, 1, bias=False))
            self.add_module(f"adapter{i}_norm", GroupNorm(32, d, eps=FLAX_EPS))
            self.add_module(f"fpn{i}_conv", Conv2d(d, d, 3, padding=1, bias=False))
            self.add_module(f"fpn{i}_norm", GroupNorm(32, d, eps=FLAX_EPS))
        self.mask_projection = Conv2d(d, cfg.mask_feature_size, 1)

    def forward(self, features):
        cfg = self.cfg
        d, nl = cfg.feature_size, cfg.num_feature_levels
        embeds, poses, shapes = [], [], []
        for i, f in enumerate(features[::-1][:nl]):  # [s32, s16, s8]
            x = getattr(self, f"input_proj{i}_conv")(f.permute(0, 3, 1, 2))
            x = getattr(self, f"input_proj{i}_norm")(x).permute(0, 2, 3, 1)
            b, h, w, _ = x.shape
            embeds.append(x.reshape(b, h * w, d))
            pos = sine_position_embedding(h, w, d // 2, device=x.device).to(x.dtype)
            poses.append(pos.reshape(1, h * w, d) + self.level_embed[i][None, None])
            shapes.append((h, w))

        x = torch.cat(embeds, dim=1)
        pos = torch.cat(poses, dim=1)
        ref = reference_points_for_shapes(shapes, x.device)[None, :, None, :].expand(1, -1, nl, 2)
        for li in range(cfg.encoder_layers):
            x = getattr(self, f"layer{li}")(x, pos, ref, shapes)

        outputs, start = [], 0
        b = x.shape[0]
        for h, w in shapes:
            outputs.append(x[:, start : start + h * w].reshape(b, h, w, d))
            start += h * w

        for i, f in enumerate(list(features[: self.num_fpn])[::-1]):
            lateral = getattr(self, f"adapter{i}_norm")(getattr(self, f"adapter{i}_conv")(f.permute(0, 3, 1, 2)))
            lateral = lateral.permute(0, 2, 3, 1)
            y = lateral + resize_bilinear(outputs[-1], tuple(lateral.shape[1:3]))
            y = getattr(self, f"fpn{i}_norm")(getattr(self, f"fpn{i}_conv")(y.permute(0, 3, 1, 2)))
            outputs.append(F.relu(y).permute(0, 2, 3, 1))

        mask_features = self.mask_projection(outputs[-1].permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        return mask_features, tuple(outputs[:nl])
