"""The reference model of versions 0.0.0 and 0.4.0, float32: the channel
builder, Swin-T, the 0.4.0 fusion (E-DSAM ratio, DSAM cascade, DGGM residual,
summed over detached backbone maps), the deformable pixel decoder and the
masked-attention transformer decoder. Module and parameter names are the
port's, so that one state dict loads into both. Train mode draws drop path,
dropout and nothing else from the caller's generator, in the port's order.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from . import ops
from .config import Config, Swin
from .lowp import q as _q

FLAX_EPS = 1e-6

# --- the channel builder (data/device_preprocess.py at the frames' own size) ---

IMAGE_MEAN = (0.485, 0.456, 0.406)
IMAGE_STD = (0.229, 0.224, 0.225)


def _normalize_u8(img_u8: torch.Tensor) -> torch.Tensor:
    x = img_u8.to(torch.float32) * torch.tensor(1.0 / 255.0, dtype=torch.float32, device=img_u8.device)
    mean = torch.tensor(IMAGE_MEAN, dtype=torch.float32, device=x.device)
    std = torch.tensor(IMAGE_STD, dtype=torch.float32, device=x.device)
    return (x - mean) / std


def _pil_gray_u8(rgb_u8: torch.Tensor) -> torch.Tensor:
    x = rgb_u8.to(torch.int32)
    return ((x[..., 0] * 19595 + x[..., 1] * 38470 + x[..., 2] * 7471 + 0x8000) >> 16).to(torch.uint8)


def channel_stack(version: str, packed_u8: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3 | 6) raw uint8 frames (rgb | depth as RGB) -> the float32
    stack: 0.0.0 the normalised RGB; 0.4.0 RGB, depth, the Sobel gradient
    magnitude of the gray depth (3 copies) and its validity."""
    color = _normalize_u8(packed_u8[..., :3])
    if version == "0.0.0":
        return color
    depth = packed_u8[..., 3:6]
    gray = _pil_gray_u8(depth).to(torch.float32)
    norm_mag, _, _, valid = ops.gradient_features(gray)
    return torch.cat([color, _normalize_u8(depth), norm_mag[..., None].expand(*norm_mag.shape, 3), valid[..., None]],
                     dim=-1)


def unpack_masks(packed_u8: torch.Tensor, hw) -> torch.Tensor:
    """np.packbits masks (..., ceil(H*W/8)) -> (..., H, W) float32 0/1."""
    h, w = hw
    shifts = torch.arange(7, -1, -1, dtype=torch.int32, device=packed_u8.device)
    bits = (packed_u8.to(torch.int32)[..., None] >> shifts) & 1
    return bits.reshape(*packed_u8.shape[:-1], -1)[..., : h * w].reshape(*packed_u8.shape[:-1], h, w).float()


# --- layers: torch's, with the control's rounding of products' operands ---


class Linear(nn.Linear):
    def forward(self, x):
        return F.linear(_q(x), _q(self.weight), self.bias)


class Conv2d(nn.Conv2d):
    def forward(self, x):
        return self._conv_forward(_q(x), _q(self.weight), self.bias)


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


# --- Swin-T (models/swin.py) ---


def _window_partition(x, ws):
    b, h, w, c = x.shape
    return x.reshape(b, h // ws, ws, w // ws, ws, c).permute(0, 1, 3, 2, 4, 5).reshape(-1, ws * ws, c)


def _window_unpartition(x, ws, h, w):
    b = x.shape[0] // ((h // ws) * (w // ws))
    return x.reshape(b, h // ws, w // ws, ws, ws, x.shape[-1]).permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, -1)


def _relative_position_index(ws):
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws), indexing="ij")).reshape(2, -1)
    rel = (coords[:, :, None] - coords[:, None, :]).transpose(1, 2, 0)
    rel[:, :, 0] += ws - 1
    rel[:, :, 1] += ws - 1
    rel[:, :, 0] *= 2 * ws - 1
    return rel.sum(-1)


def _shift_attn_mask(hp, wp, ws, shift, device):
    ph = torch.arange(hp, device=device)
    rh = (ph >= hp - ws).long() + (ph >= hp - shift).long()
    pw = torch.arange(wp, device=device)
    rw = (pw >= wp - ws).long() + (pw >= wp - shift).long()
    img = rh[:, None] * 3 + rw[None, :]
    win = img.reshape(hp // ws, ws, wp // ws, ws).permute(0, 2, 1, 3).reshape(-1, ws * ws)
    diff = win[:, None, :] - win[:, :, None]
    return torch.where(diff != 0, -100.0, 0.0)


class WindowAttention(nn.Module):
    def __init__(self, dim, num_heads, ws, qkv_bias=True):
        super().__init__()
        self.num_heads, self.head_dim = num_heads, dim // num_heads
        self.query, self.key, self.value = (Linear(dim, dim, bias=qkv_bias) for _ in range(3))
        self.proj = Linear(dim, dim)
        self.relative_position_bias_table = nn.Parameter(torch.zeros((2 * ws - 1) ** 2, num_heads))
        self.register_buffer("rel_index", torch.from_numpy(_relative_position_index(ws).reshape(-1)), persistent=False)

    def forward(self, x, attn_mask):
        nb, n, _ = x.shape
        nh, hd = self.num_heads, self.head_dim
        w = torch.cat([self.query.weight, self.key.weight, self.value.weight], dim=0)
        bias = torch.cat([self.query.bias, self.key.bias, self.value.bias]) if self.query.bias is not None else None
        qkv = F.linear(_q(x), _q(w), bias).reshape(nb, n, 3, nh, hd).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]
        attn = _q(q * hd**-0.5) @ _q(k).transpose(-1, -2)
        attn = attn + self.relative_position_bias_table[self.rel_index].reshape(n, n, nh).permute(2, 0, 1)[None]
        if attn_mask is not None:
            nw = attn_mask.shape[0]
            attn = (attn.reshape(nb // nw, nw, nh, n, n) + attn_mask[None, :, None]).reshape(nb, nh, n, n)
        attn = torch.softmax(attn, dim=-1)
        return self.proj((_q(attn) @ _q(v)).transpose(1, 2).reshape(nb, n, nh * hd))


class SwinBlock(nn.Module):
    def __init__(self, cfg: Swin, dim, num_heads, shift, rate):
        super().__init__()
        self.ws, self.shift, self.rate = cfg.window_size, shift, rate
        self.norm1 = nn.LayerNorm(dim, eps=cfg.layer_norm_eps)
        self.attention = WindowAttention(dim, num_heads, cfg.window_size, cfg.qkv_bias)
        self.norm2 = nn.LayerNorm(dim, eps=cfg.layer_norm_eps)
        self.mlp_fc1 = Linear(dim, int(dim * cfg.mlp_ratio))
        self.mlp_fc2 = Linear(int(dim * cfg.mlp_ratio), dim)

    def forward(self, x, gen):
        b, h, w, c = x.shape
        ws, shift = self.ws, self.shift
        shortcut = x
        x = self.norm1(x)
        pad_h, pad_w = (ws - h % ws) % ws, (ws - w % ws) % ws
        if pad_h or pad_w:
            x = F.pad(x, (0, 0, 0, pad_w, 0, pad_h))
        hp, wp = h + pad_h, w + pad_w
        mask = None
        if shift > 0:
            x = torch.roll(x, (-shift, -shift), dims=(1, 2))
            mask = _shift_attn_mask(hp, wp, ws, shift, x.device)
        x = _window_unpartition(self.attention(_window_partition(x, ws), mask), ws, hp, wp)
        if shift > 0:
            x = torch.roll(x, (shift, shift), dims=(1, 2))
        x = shortcut + ops.drop_path(x[:, :h, :w], self.rate, self.training, gen)
        y = self.mlp_fc2(F.gelu(self.mlp_fc1(self.norm2(x))))
        return x + ops.drop_path(y, self.rate, self.training, gen)


class PatchMerging(nn.Module):
    def __init__(self, cfg: Swin, dim):
        super().__init__()
        self.norm = nn.LayerNorm(4 * dim, eps=cfg.layer_norm_eps)
        self.reduction = Linear(4 * dim, 2 * dim, bias=False)

    def forward(self, x):
        h, w = x.shape[1:3]
        if h % 2 or w % 2:
            x = F.pad(x, (0, 0, 0, w % 2, 0, h % 2))
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2], x[:, 1::2, 1::2]], dim=-1)
        return self.reduction(self.norm(x))


class SwinBackbone(nn.Module):
    def __init__(self, cfg: Swin, in_channels=3):
        super().__init__()
        self.cfg = cfg
        self.patch_embed = Conv2d(in_channels, cfg.embed_dim, cfg.patch_size, stride=cfg.patch_size)
        self.patch_norm = nn.LayerNorm(cfg.embed_dim, eps=cfg.layer_norm_eps)
        dim = cfg.embed_dim
        rates = iter(np.linspace(0, cfg.drop_path_rate, sum(cfg.depths)))
        for s, depth in enumerate(cfg.depths):
            for blk in range(depth):
                shift = 0 if blk % 2 == 0 else cfg.window_size // 2
                self.add_module(f"stage{s}_block{blk}", SwinBlock(cfg, dim, cfg.num_heads[s], shift, float(next(rates))))
            self.add_module(f"out_norm{s}", nn.LayerNorm(dim, eps=cfg.layer_norm_eps))
            if s < len(cfg.depths) - 1:
                self.add_module(f"downsample{s}", PatchMerging(cfg, dim))
                dim *= 2

    def forward(self, x, gen):
        cfg = self.cfg
        h, w = x.shape[1:3]
        ps = cfg.patch_size
        pad_h, pad_w = (ps - h % ps) % ps, (ps - w % ps) % ps
        if pad_h or pad_w:
            x = F.pad(x, (0, 0, 0, pad_w, 0, pad_h))
        x = self.patch_norm(_nhwc(self.patch_embed(_nchw(x).contiguous())))
        feats = []
        for s, depth in enumerate(cfg.depths):
            for blk in range(depth):
                x = getattr(self, f"stage{s}_block{blk}")(x, gen)
            feats.append(getattr(self, f"out_norm{s}")(x))
            if s < len(cfg.depths) - 1:
                x = getattr(self, f"downsample{s}")(x)
        return feats


# --- the 0.4.0 fusion (models/fusion.py) ---


class EnhancedDepthImageRatioPredictor(nn.Module):
    def __init__(self, in_channels=3, out_min=0.01, out_max=0.5):
        super().__init__()
        self.out_min, self.out_max = out_min, out_max
        for i, k in enumerate((3, 5, 7)):
            self.add_module(f"scale{i}_conv", Conv2d(in_channels, 64, k, padding=k // 2))
        self.scales_bn = nn.BatchNorm2d(192, eps=1e-5)
        self.fusion_conv = Conv2d(192, 128, 1)
        self.fusion_bn = nn.BatchNorm2d(128, eps=1e-5)
        self.attn_conv0 = Conv2d(128, 64, 1)
        self.attn_conv1 = Conv2d(64, 128, 1)
        self.extract_conv0 = Conv2d(128, 256, 3, padding=1)
        self.extract_bn0 = nn.BatchNorm2d(256, eps=1e-5)
        self.extract_conv1 = Conv2d(256, 512, 3, padding=1)
        self.extract_bn1 = nn.BatchNorm2d(512, eps=1e-5)
        self.fc0, self.fc1, self.fc2, self.fc3 = Linear(512, 128), Linear(128, 64), Linear(64, 32), Linear(32, 1)

    def forward(self, depth, gen):
        x = _nchw(depth).contiguous()
        x = torch.cat([self.scale0_conv(x), self.scale1_conv(x), self.scale2_conv(x)], dim=1)
        x = F.relu(self.scales_bn(x))
        x = F.relu(self.fusion_bn(self.fusion_conv(x)))
        x = x * torch.sigmoid(self.attn_conv1(F.relu(self.attn_conv0(x))))
        x = F.relu(self.extract_bn0(self.extract_conv0(x)))
        x = _nchw(ops.adaptive_avg_pool2d(_nhwc(x), (4, 4)))
        x = F.relu(self.extract_bn1(self.extract_conv1(x))).mean(dim=(2, 3))
        x = ops.dropout(F.relu(self.fc0(x)), 0.3, self.training, gen)
        x = ops.dropout(F.relu(self.fc1(x)), 0.2, self.training, gen)
        raw = self.fc3(F.relu(self.fc2(x)))
        return self.out_min + (self.out_max - self.out_min) * torch.sigmoid(raw)


class DSAModule(nn.Module):
    def __init__(self, cin, cout, num_regions=3):
        super().__init__()
        self.num_regions = num_regions
        self.strided = cin != cout
        for i in range(num_regions + 1):
            self.add_module(f"conv{i}", Conv2d(cin, cout, 3, stride=2, padding=1) if self.strided else Conv2d(cin, cout, 1))
        if self.strided:
            self.rgb_projection = Conv2d(cin, cout, 3, stride=2, padding=1, bias=False)

    def forward(self, features, masks, active):
        f, m = _nchw(features), _nchw(masks)
        enhanced = None
        for i in range(self.num_regions + 1):
            y = getattr(self, f"conv{i}")(f * m[:, i : i + 1]) * active[:, i][:, None, None, None]
            enhanced = y if enhanced is None else enhanced + y
        return _nhwc(enhanced + (self.rgb_projection(f) if self.strided else f))


class DSAMCascade(nn.Module):
    def __init__(self, channels, num_regions=3, hist_bins=512, prominence=0.01):
        super().__init__()
        self.num_regions, self.hist_bins, self.prominence = num_regions, hist_bins, prominence
        for k in range(3):
            self.add_module(f"dsam{k}", DSAModule(channels[k], channels[k + 1], num_regions))

    def forward(self, color_maps, depth_3ch, ratio):
        gray = ops.to_grayscale(depth_3ch)
        maps = list(color_maps)
        th0, tw0 = maps[0].shape[1:3]
        sizes = [tuple(m.shape[1:3]) for m in maps[:3]]
        chain_ok = (gray.shape[1] % th0 == 0 and gray.shape[2] % tw0 == 0
                    and all(sizes[k][0] % sizes[k + 1][0] == 0 and sizes[k][1] % sizes[k + 1][1] == 0 for k in range(2)))
        opts = dict(num_modes=self.num_regions, bins=self.hist_bins, prominence_frac=self.prominence)
        if chain_ok:
            mk, active = ops.dsam_region_masks_pooled(gray, ratio, (th0, tw0), **opts)
            mk_full = mk
        else:
            masks, active = ops.dsam_region_masks(gray, ratio, **opts)
            mk = mk_full = masks.permute(0, 2, 3, 1)
        for k in range(3):
            th, tw = maps[k].shape[1:3]
            if tuple(mk.shape[1:3]) != (th, tw):
                src = mk if (mk.shape[1] % th == 0 and mk.shape[2] % tw == 0) else mk_full
                mk = ops.adaptive_max_pool2d(src, (th, tw))
            maps[k + 1] = maps[k + 1] + getattr(self, f"dsam{k}")(maps[k], mk, active)
        return maps


class DepthGradientInjectionResidual(nn.Module):
    def __init__(self, channels, grad_channels=3):
        super().__init__()
        for i, c in enumerate(channels):
            self.add_module(f"enhance{i}", Conv2d(grad_channels, c, 1))

    def forward(self, color_maps, gradient, mask):
        out = []
        for i, c in enumerate(color_maps):
            size = tuple(c.shape[1:3])
            gated = ops.resize_bilinear(gradient, size) * ops.resize_nearest(mask, size)
            out.append(c + _nhwc(F.relu(getattr(self, f"enhance{i}")(_nchw(gated)))))
        return out


# --- the pixel decoder (models/pixel_decoder.py) ---


def _f32_reciprocal(n: int) -> float:
    return float(np.float32(1.0) / np.float32(n))


def offset_bias_grid(num_heads, n_levels, n_points) -> np.ndarray:
    """Deformable-DETR sampling-offset bias: per-head unit directions scaled by point index."""
    thetas = np.arange(num_heads, dtype=np.float64) * (2.0 * np.pi / num_heads)
    grid = np.stack([np.cos(thetas), np.sin(thetas)], -1)
    grid = grid / np.abs(grid).max(-1, keepdims=True)
    grid = np.tile(grid[:, None, None, :], (1, n_levels, n_points, 1))
    for i in range(n_points):
        grid[:, :, i, :] *= i + 1
    return grid.reshape(-1).astype(np.float32)


def reference_points(spatial_shapes, device) -> torch.Tensor:
    """(L_total, 2) half-pixel points, (i + 0.5) times the float32 reciprocal of the size."""
    pts = []
    for h, w in spatial_shapes:
        ry = (torch.arange(h, dtype=torch.float32, device=device) + 0.5) * _f32_reciprocal(h)
        rx = (torch.arange(w, dtype=torch.float32, device=device) + 0.5) * _f32_reciprocal(w)
        gy, gx = torch.meshgrid(ry, rx, indexing="ij")
        pts.append(torch.stack([gx.reshape(-1), gy.reshape(-1)], dim=-1))
    return torch.cat(pts, dim=0)


def sampling_locations(ref, offsets, spatial_shapes) -> torch.Tensor:
    """ref (B, L, nl, 2) + pixel offsets (B, L, nh, nl, P, 2) over each level's
    (w, h), the product exact in float64 and the sum rounded to float32."""
    inv = torch.tensor([[_f32_reciprocal(w), _f32_reciprocal(h)] for (h, w) in spatial_shapes],
                       dtype=torch.float64, device=offsets.device)
    return (ref.double()[:, :, None, :, None, :] + offsets.double() * inv[None, None, None, :, None, :]).float()


class DeformableAttention(nn.Module):
    def __init__(self, cfg: Config):
        super().__init__()
        d, nh, nl, npts = cfg.feature_size, cfg.num_attention_heads, cfg.num_feature_levels, cfg.deformable_points
        self.nh, self.nl, self.npts = nh, nl, npts
        self.value_proj = Linear(d, d)
        self.sampling_offsets = Linear(d, nh * nl * npts * 2)
        self.attention_weights = Linear(d, nh * nl * npts)
        self.output_proj = Linear(d, d)

    def forward(self, x, pos, ref, shapes):
        b, l, d = x.shape
        nh, nl, npts = self.nh, len(shapes), self.npts
        with_pos = x + pos
        value = self.value_proj(x).reshape(b, l, nh, d // nh)
        offsets = self.sampling_offsets(with_pos).reshape(b, l, nh, nl, npts, 2)
        weights = torch.softmax(self.attention_weights(with_pos).reshape(b, l, nh, nl * npts), dim=-1)
        loc = sampling_locations(ref, offsets, shapes)
        return self.output_proj(ops.deform_sample(value, shapes, loc, weights.reshape(b, l, nh, nl, npts)))


class EncoderLayer(nn.Module):
    def __init__(self, cfg: Config):
        super().__init__()
        d = cfg.feature_size
        self.self_attn = DeformableAttention(cfg)
        self.self_attn_layer_norm = nn.LayerNorm(d, eps=FLAX_EPS)
        self.fc1 = Linear(d, cfg.encoder_feedforward_dim)
        self.fc2 = Linear(cfg.encoder_feedforward_dim, d)
        self.final_layer_norm = nn.LayerNorm(d, eps=FLAX_EPS)

    def forward(self, x, pos, ref, shapes):
        x = self.self_attn_layer_norm(x + self.self_attn(x, pos, ref, shapes))
        return self.final_layer_norm(x + self.fc2(F.relu(self.fc1(x))))


class PixelDecoder(nn.Module):
    def __init__(self, cfg: Config, in_channels):
        super().__init__()
        self.cfg = cfg
        d, nl = cfg.feature_size, cfg.num_feature_levels
        self.level_embed = nn.Parameter(torch.zeros(nl, d))
        for i, c in enumerate(in_channels[::-1][:nl]):
            self.add_module(f"input_proj{i}_conv", Conv2d(c, d, 1))
            self.add_module(f"input_proj{i}_norm", nn.GroupNorm(32, d, eps=FLAX_EPS))
        for li in range(cfg.encoder_layers):
            self.add_module(f"layer{li}", EncoderLayer(cfg))
        self.num_fpn = int(np.log2(min(cfg.feature_strides[-nl:])) - np.log2(cfg.common_stride))
        for i, c in enumerate(list(in_channels[: self.num_fpn])[::-1]):
            self.add_module(f"adapter{i}_conv", Conv2d(c, d, 1, bias=False))
            self.add_module(f"adapter{i}_norm", nn.GroupNorm(32, d, eps=FLAX_EPS))
            self.add_module(f"fpn{i}_conv", Conv2d(d, d, 3, padding=1, bias=False))
            self.add_module(f"fpn{i}_norm", nn.GroupNorm(32, d, eps=FLAX_EPS))
        self.mask_projection = Conv2d(d, cfg.mask_feature_size, 1)

    def forward(self, features):
        d, nl = self.cfg.feature_size, self.cfg.num_feature_levels
        embeds, poses, shapes = [], [], []
        for i, f in enumerate(features[::-1][:nl]):
            x = _nhwc(getattr(self, f"input_proj{i}_norm")(getattr(self, f"input_proj{i}_conv")(_nchw(f))))
            b, h, w, _ = x.shape
            embeds.append(x.reshape(b, h * w, d))
            poses.append(ops.sine_position_embedding(h, w, d // 2, device=x.device).reshape(1, h * w, d)
                         + self.level_embed[i][None, None])
            shapes.append((h, w))
        x, pos = torch.cat(embeds, dim=1), torch.cat(poses, dim=1)
        ref = reference_points(shapes, x.device)[None, :, None, :].expand(1, -1, nl, 2)
        for li in range(self.cfg.encoder_layers):
            x = getattr(self, f"layer{li}")(x, pos, ref, shapes)
        outputs, start, b = [], 0, x.shape[0]
        for h, w in shapes:
            outputs.append(x[:, start : start + h * w].reshape(b, h, w, d))
            start += h * w
        for i, f in enumerate(list(features[: self.num_fpn])[::-1]):
            lateral = _nhwc(getattr(self, f"adapter{i}_norm")(getattr(self, f"adapter{i}_conv")(_nchw(f))))
            y = lateral + ops.resize_bilinear(outputs[-1], tuple(lateral.shape[1:3]))
            outputs.append(F.relu(_nhwc(getattr(self, f"fpn{i}_norm")(getattr(self, f"fpn{i}_conv")(_nchw(y))))))
        return _nhwc(self.mask_projection(_nchw(outputs[-1]))), tuple(outputs[:nl])


# --- the transformer decoder (models/transformer_decoder.py) ---


class MultiheadAttention(nn.Module):
    def __init__(self, dim, num_heads):
        super().__init__()
        self.num_heads = num_heads
        self.q_proj, self.k_proj, self.v_proj, self.out_proj = (Linear(dim, dim) for _ in range(4))

    def forward(self, query, key, value, attn_mask=None):
        nh = self.num_heads

        def split(t):
            b, l, d = t.shape
            return t.reshape(b, l, nh, d // nh).transpose(1, 2)

        q = split(self.q_proj(query)) * (query.shape[-1] // nh) ** -0.5
        k, v = split(self.k_proj(key)), split(self.v_proj(value))
        if attn_mask is not None:
            out = ops.masked_cross_attention(q, k, v, *attn_mask)
        else:
            out = _q(torch.softmax(_q(q) @ _q(k).transpose(-1, -2), dim=-1)) @ _q(v)
        b, _, l, hd = out.shape
        return self.out_proj(out.transpose(1, 2).reshape(b, l, nh * hd))


class DecoderLayer(nn.Module):
    def __init__(self, cfg: Config):
        super().__init__()
        d = cfg.hidden_dim
        self.cross_attn = MultiheadAttention(d, cfg.num_attention_heads)
        self.cross_attn_layer_norm = nn.LayerNorm(d, eps=FLAX_EPS)
        self.self_attn = MultiheadAttention(d, cfg.num_attention_heads)
        self.self_attn_layer_norm = nn.LayerNorm(d, eps=FLAX_EPS)
        self.fc1, self.fc2 = Linear(d, cfg.dim_feedforward), Linear(cfg.dim_feedforward, d)
        self.final_layer_norm = nn.LayerNorm(d, eps=FLAX_EPS)

    def forward(self, hidden, query_pos, memory, memory_pos, attn_mask):
        hidden = self.cross_attn_layer_norm(hidden + self.cross_attn(hidden + query_pos, memory + memory_pos, memory,
                                                                     attn_mask))
        hidden = self.self_attn_layer_norm(hidden + self.self_attn(hidden + query_pos, hidden + query_pos, hidden))
        return self.final_layer_norm(hidden + self.fc2(F.relu(self.fc1(hidden))))


class MaskPredictor(nn.Module):
    def __init__(self, cfg: Config):
        super().__init__()
        d = cfg.hidden_dim
        self.mask_embedder0, self.mask_embedder1 = Linear(d, d), Linear(d, d)
        self.mask_embedder2 = Linear(d, cfg.mask_feature_size)

    def forward(self, intermediate, mask_features, target_hw):
        x = self.mask_embedder2(F.relu(self.mask_embedder1(F.relu(self.mask_embedder0(intermediate)))))
        outputs_mask = torch.einsum("bqc,bhwc->bqhw", _q(x), _q(mask_features))
        return outputs_mask, attention_mask(outputs_mask, target_hw)


def attention_mask(outputs_mask, target_hw):
    """The next layer's attention mask from a layer's mask logits (B, Q, H, W):
    the logits resized to the level's (h, w), flattened, and the queries that block every key."""
    b, q = outputs_mask.shape[:2]
    am = ops.resize_bilinear(outputs_mask.permute(0, 2, 3, 1), target_hw).permute(0, 3, 1, 2)
    am = am.reshape(b, q, -1).detach()
    return am, (am < 0.0).all(dim=-1)


class TransformerModule(nn.Module):
    def __init__(self, cfg: Config):
        super().__init__()
        self.cfg = cfg
        d, nl = cfg.hidden_dim, cfg.num_feature_levels
        self.level_embed = nn.Parameter(torch.zeros(nl, d))
        self.queries_embedder = nn.Parameter(torch.zeros(cfg.num_queries, d))
        self.queries_features = nn.Parameter(torch.zeros(cfg.num_queries, d))
        self.decoder_layernorm = nn.LayerNorm(d, eps=FLAX_EPS)
        self.mask_predictor = MaskPredictor(cfg)
        self.class_predictor = Linear(d, cfg.num_labels + 1)
        for idx in range(cfg.decoder_layers - 1):
            self.add_module(f"layer{idx}", DecoderLayer(cfg))

    def forward(self, multi_scale, mask_features, forced=None):
        """`forced`: a layer's mask logits per layer but the last, from which the
        attention masks are derived in place of this model's own."""
        cfg = self.cfg
        d, nl = cfg.hidden_dim, cfg.num_feature_levels
        b = mask_features.shape[0]
        memories, poses, sizes = [], [], []
        for i in range(nl):
            h, w = multi_scale[i].shape[1:3]
            sizes.append((h, w))
            memories.append(multi_scale[i].reshape(b, h * w, d) + self.level_embed[i][None, None])
            poses.append(ops.sine_position_embedding(h, w, d // 2, device=mask_features.device).reshape(1, h * w, d))
        query_pos = self.queries_embedder[None].expand(b, -1, -1)
        hidden = self.queries_features[None].expand(b, -1, -1)
        intermediate = self.decoder_layernorm(hidden)
        classes = [self.class_predictor(intermediate)]
        mask, attn_mask = self.mask_predictor(intermediate, mask_features, sizes[0])
        masks = [mask]
        for idx in range(cfg.decoder_layers - 1):
            lvl = idx % nl
            if forced is not None:
                attn_mask = attention_mask(forced[idx], sizes[lvl])
            hidden = getattr(self, f"layer{idx}")(hidden, query_pos, memories[lvl], poses[lvl], attn_mask)
            intermediate = self.decoder_layernorm(hidden)
            classes.append(self.class_predictor(intermediate))
            mask, attn_mask = self.mask_predictor(intermediate, mask_features, sizes[(idx + 1) % nl])
            masks.append(mask)
        return classes, masks


# --- the model (models/mask2former.py, versions 0.0.0 and 0.4.0) ---


class PixelLevelModule(nn.Module):
    def __init__(self, cfg: Config):
        super().__init__()
        self.cfg = cfg
        channels = cfg.backbone.channels
        self.encoder = SwinBackbone(cfg.backbone, 3)
        if cfg.version == "0.4.0":
            self.ratio_predictor = EnhancedDepthImageRatioPredictor(3)
            self.dsam_cascade = DSAMCascade(channels, cfg.dsam_num_regions, cfg.dsam_hist_bins, cfg.dsam_prominence)
            self.dggm = DepthGradientInjectionResidual(channels)
        self.pixel_decoder = PixelDecoder(cfg, channels)

    def forward(self, pixels, gen):
        maps = self.encoder(pixels[..., 0:3], gen)
        if self.cfg.version == "0.4.0":
            ratio = self.ratio_predictor(pixels[..., 3:6], gen)[:, 0]
            detached = [m.detach() for m in maps]
            branch1 = self.dsam_cascade(list(detached), pixels[..., 3:6], ratio)
            branch2 = self.dggm(list(detached), pixels[..., 6:9], pixels[..., 9:10])
            maps = [a + b for a, b in zip(branch1, branch2)]
        return self.pixel_decoder(maps)


class Mask2Former(nn.Module):
    """(B, H, W, C) channel stack -> (class logits per layer, mask logits per layer), the final layer last."""

    def __init__(self, cfg: Config):
        super().__init__()
        self.cfg = cfg
        self.pixel_level_module = PixelLevelModule(cfg)
        self.transformer_module = TransformerModule(cfg)

    def forward(self, pixels, gen=None, forced=None):
        if pixels.shape[-1] != self.cfg.channels_in:
            raise ValueError(f"version {self.cfg.version} takes {self.cfg.channels_in} channels, got {pixels.shape[-1]}")
        mask_features, multi_scale = self.pixel_level_module(pixels.contiguous(), gen)
        return self.transformer_module(multi_scale, mask_features, forced)
