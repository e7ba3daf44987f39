"""Swin Transformer backbone (Swin-T defaults)
(counterpart of `rgbdseg_tpu/models/swin.py`).

Input (B, H, W, C) channels-last -> 4 channels-last feature maps at strides
4/8/16/32 with channels [C, 2C, 4C, 8C], each taken before the stage's
patch-merging and passed through a per-stage LayerNorm (eps 1e-5). HF
`always_partition` semantics: the window and shift are not shrunk for small
maps; maps are zero-padded to window multiples. The shifted-window mask adds
-100 between regions. In train mode each block's two residual branches go
through drop path, its rate scheduled linearly over all blocks from 0 to
`drop_path_rate` (0.3 for Swin-T), with masks from the caller's generator.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..config import SwinConfig
from .layers import Conv2d, LayerNorm, Linear, promote
from .stochastic import drop_path


def window_partition(x: torch.Tensor, ws: int) -> torch.Tensor:
    """(B, H, W, C) -> (B * nH * nW, ws*ws, C); H, W multiples of ws."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // ws, ws, w // ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, ws * ws, c)


def window_unpartition(x: torch.Tensor, ws: int, h: int, w: int) -> torch.Tensor:
    b = x.shape[0] // ((h // ws) * (w // ws))
    x = x.reshape(b, h // ws, w // ws, ws, ws, x.shape[-1]).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h, w, -1)


def relative_position_index(ws: int) -> np.ndarray:
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws), indexing="ij")).reshape(2, -1)
    rel = (coords[:, :, None] - coords[:, None, :]).transpose(1, 2, 0)
    rel[:, :, 0] += ws - 1
    rel[:, :, 1] += ws - 1
    rel[:, :, 0] *= 2 * ws - 1
    return rel.sum(-1)  # (ws², ws²)


def shift_attn_mask(hp: int, wp: int, ws: int, shift: int, device) -> torch.Tensor:
    """(nW, ws², ws²) additive mask: -100 between cells of different shift regions."""
    ph = torch.arange(hp, device=device)
    rh = (ph >= hp - ws).long() + (ph >= hp - shift).long()
    pw = torch.arange(wp, device=device)
    rw = (pw >= wp - ws).long() + (pw >= wp - shift).long()
    img = rh[:, None] * 3 + rw[None, :]
    win = img.reshape(hp // ws, ws, wp // ws, ws).permute(0, 2, 1, 3).reshape(-1, ws * ws)
    diff = win[:, None, :] - win[:, :, None]
    return torch.where(diff != 0, -100.0, 0.0)


class WindowAttention(nn.Module):
    """Window self-attention with relative position bias. The query/key/value
    projections are kept as separate Linear modules (checkpoint layout) and
    applied as one fused (C, 3C) product."""

    def __init__(self, dim: int, num_heads: int, window_size: int, qkv_bias: bool = True):
        super().__init__()
        self.num_heads = num_heads
        self.window_size = window_size
        self.query = Linear(dim, dim, bias=qkv_bias)
        self.key = Linear(dim, dim, bias=qkv_bias)
        self.value = Linear(dim, dim, bias=qkv_bias)
        self.proj = Linear(dim, dim)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window_size - 1) ** 2, num_heads)
        )
        self.register_buffer(
            "rel_index",
            torch.from_numpy(relative_position_index(window_size).reshape(-1)),
            persistent=False,
        )

    def forward(self, x: torch.Tensor, attn_mask: torch.Tensor | None) -> torch.Tensor:
        nb, n, c = x.shape
        nh = self.num_heads
        hd = c // nh
        w = torch.cat([self.query.weight, self.key.weight, self.value.weight], dim=0)
        bias = None
        if self.query.bias is not None:
            bias = torch.cat([self.query.bias, self.key.bias, self.value.bias])
        qkv = F.linear(*promote(x, w, bias)).reshape(nb, n, 3, nh, hd).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]  # (nb, nh, n, hd)
        attn = (q * hd**-0.5) @ k.transpose(-1, -2)
        rpb = self.relative_position_bias_table[self.rel_index].reshape(n, n, nh).permute(2, 0, 1)
        attn = attn.float() + rpb[None].float()
        if attn_mask is not None:
            nw = attn_mask.shape[0]
            attn = attn.reshape(nb // nw, nw, nh, n, n) + attn_mask[None, :, None]
            attn = attn.reshape(nb, nh, n, n)
        attn = torch.softmax(attn, dim=-1).to(v.dtype)
        out = (attn @ v).transpose(1, 2).reshape(nb, n, c)
        return self.proj(out)


class SwinBlock(nn.Module):
    def __init__(self, cfg: SwinConfig, dim: int, num_heads: int, shift: int, drop_path_rate: float = 0.0):
        super().__init__()
        self.window_size = cfg.window_size
        self.shift = shift
        self.drop_path_rate = drop_path_rate
        eps = cfg.layer_norm_eps
        self.norm1 = LayerNorm(dim, eps=eps)
        self.attention = WindowAttention(dim, num_heads, cfg.window_size, cfg.qkv_bias)
        self.norm2 = LayerNorm(dim, eps=eps)
        hidden = int(dim * cfg.mlp_ratio)
        self.mlp_fc1 = Linear(dim, hidden)
        self.mlp_fc2 = Linear(hidden, dim)

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        b, h, w, c = x.shape
        ws, shift = self.window_size, self.shift
        rate = self.drop_path_rate
        shortcut = x
        x = self.norm1(x)
        pad_h = (ws - h % ws) % ws
        pad_w = (ws - w % ws) % ws
        if pad_h or pad_w:
            x = F.pad(x, (0, 0, 0, pad_w, 0, pad_h))
        hp, wp = h + pad_h, w + pad_w
        attn_mask = None
        if shift > 0:
            x = torch.roll(x, (-shift, -shift), dims=(1, 2))
            attn_mask = shift_attn_mask(hp, wp, ws, shift, x.device)
        x = window_unpartition(self.attention(window_partition(x, ws), attn_mask), ws, hp, wp)
        if shift > 0:
            x = torch.roll(x, (shift, shift), dims=(1, 2))
        x = shortcut + drop_path(x[:, :h, :w], rate, self.training, generator)
        y = self.mlp_fc2(F.gelu(self.mlp_fc1(self.norm2(x))))
        return x + drop_path(y, rate, self.training, generator)


class PatchMerging(nn.Module):
    def __init__(self, cfg: SwinConfig, dim: int):
        super().__init__()
        self.norm = LayerNorm(4 * dim, eps=cfg.layer_norm_eps)
        self.reduction = Linear(4 * dim, 2 * dim, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, w = x.shape[1:3]
        if h % 2 or w % 2:
            x = F.pad(x, (0, 0, 0, w % 2, 0, h % 2))
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2], x[:, 1::2, 1::2]], dim=-1)
        return self.reduction(self.norm(x))


class SwinBackbone(nn.Module):
    """(B, H, W, C) -> 4 channels-last maps (strides 4/8/16/32), LayerNorm'ed per stage."""

    def __init__(self, cfg: SwinConfig, in_channels: int | None = None):
        super().__init__()
        self.cfg = cfg
        ps = cfg.patch_size
        self.patch_embed = Conv2d(in_channels or cfg.num_channels, cfg.embed_dim, ps, stride=ps)
        self.patch_norm = LayerNorm(cfg.embed_dim, eps=cfg.layer_norm_eps) if cfg.patch_norm else None
        dim = cfg.embed_dim
        rates = iter(np.linspace(0, cfg.drop_path_rate, sum(cfg.depths)))
        for stage in range(cfg.num_layers):
            for blk in range(cfg.depths[stage]):
                shift = 0 if blk % 2 == 0 else cfg.window_size // 2
                block = SwinBlock(cfg, dim, cfg.num_heads[stage], shift, float(next(rates)))
                self.add_module(f"stage{stage}_block{blk}", block)
            self.add_module(f"out_norm{stage}", LayerNorm(dim, eps=cfg.layer_norm_eps))
            if stage < cfg.num_layers - 1:
                self.add_module(f"downsample{stage}", PatchMerging(cfg, dim))
                dim *= 2

    def forward(self, pixel_values: torch.Tensor, generator: torch.Generator | None = None) -> tuple[torch.Tensor, ...]:
        cfg = self.cfg
        x = pixel_values
        h, w = x.shape[1:3]
        ps = cfg.patch_size
        pad_h = (ps - h % ps) % ps
        pad_w = (ps - w % ps) % ps
        if pad_h or pad_w:
            x = F.pad(x, (0, 0, 0, pad_w, 0, pad_h))
        # NCHW in memory (a copy of 3 channels): the convolution's memory format,
        # and so cuDNN's kernel and its sums, do not follow the caller's layout
        x = self.patch_embed(x.permute(0, 3, 1, 2).contiguous()).permute(0, 2, 3, 1)
        if self.patch_norm is not None:
            x = self.patch_norm(x)
        features = []
        for stage in range(cfg.num_layers):
            for blk in range(cfg.depths[stage]):
                x = getattr(self, f"stage{stage}_block{blk}")(x, generator)
            features.append(getattr(self, f"out_norm{stage}")(x))
            if stage < cfg.num_layers - 1:
                x = getattr(self, f"downsample{stage}")(x)
        return tuple(features)
