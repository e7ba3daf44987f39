"""Masked-attention transformer decoder + prediction heads
(counterpart of `rgbdseg_tpu/models/transformer_decoder.py`).

`num_queries` learned queries; `decoder_layers` prediction points = 1 initial
+ (decoder_layers - 1) blocks of (masked cross-attention at level idx % 3,
self-attention, FFN), post-norm. Each mask prediction also gives the next
layer's attention mask: keys whose raw resized mask logit is < 0
(sigmoid < 0.5) are blocked, except for queries that would block every key.
Masked cross-attention goes through kernel K3
(`ops.kernels.masked_attention.masked_cross_attention`). LayerNorms use flax's
default eps 1e-6. Under tensor parallelism an attention module holds its
rank's heads (`parallel.sharding.shard_model`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..config import ModelConfig
from ..ops.kernels.masked_attention import masked_cross_attention
from ..ops.resize import resize_bilinear
from ..parallel.sharding import local_heads
from .layers import LayerNorm, Linear
from .position import sine_position_embedding

FLAX_EPS = 1e-6


def _split_heads(t: torch.Tensor, nh: int) -> torch.Tensor:
    b, l, d = t.shape
    return t.reshape(b, l, nh, d // nh).transpose(1, 2)


def _merge_heads(t: torch.Tensor) -> torch.Tensor:
    b, nh, l, hd = t.shape
    return t.transpose(1, 2).reshape(b, l, nh * hd)


class MultiheadAttention(nn.Module):
    """Dense multi-head attention; `attn_mask` is (raw mask logits, all_blocked).
    `tp` is set by tensor parallelism."""

    tp = None

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.head_dim = dim // num_heads
        self.q_proj = Linear(dim, dim)
        self.k_proj = Linear(dim, dim)
        self.v_proj = Linear(dim, dim)
        self.out_proj = Linear(dim, dim)

    def forward(self, query, key, value, attn_mask=None):
        nh, hd = local_heads(self.num_heads, self.tp), self.head_dim
        q = _split_heads(self.q_proj(query), nh) * hd**-0.5
        k = _split_heads(self.k_proj(key), nh)
        v = _split_heads(self.v_proj(value), nh)
        if attn_mask is not None:
            mask_logits, all_blocked = attn_mask
            out = masked_cross_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                                         mask_logits.contiguous(), all_blocked.contiguous())
        else:
            attn = torch.softmax((q @ k.transpose(-1, -2)).float(), dim=-1).to(v.dtype)
            out = attn @ v
        return self.out_proj(_merge_heads(out))


class DecoderLayer(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        d = cfg.hidden_dim
        self.cross_attn = MultiheadAttention(d, cfg.num_attention_heads)
        self.cross_attn_layer_norm = LayerNorm(d, eps=FLAX_EPS)
        self.self_attn = MultiheadAttention(d, cfg.num_attention_heads)
        self.self_attn_layer_norm = LayerNorm(d, eps=FLAX_EPS)
        self.fc1 = Linear(d, cfg.dim_feedforward)
        self.fc2 = Linear(cfg.dim_feedforward, d)
        self.final_layer_norm = LayerNorm(d, eps=FLAX_EPS)

    def forward(self, hidden, query_pos, memory, memory_pos, attn_mask):
        y = self.cross_attn(hidden + query_pos, memory + memory_pos, memory, attn_mask)
        hidden = self.cross_attn_layer_norm(hidden + y)
        # q and k get the position embedding; v is the raw hidden state.
        y = self.self_attn(hidden + query_pos, hidden + query_pos, hidden, None)
        hidden = self.self_attn_layer_norm(hidden + y)
        y = self.fc2(F.relu(self.fc1(hidden)))
        return self.final_layer_norm(hidden + y)


class MaskPredictor(nn.Module):
    """MLP mask embedder x pixel embeddings; also the next layer's attention mask."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        d = cfg.hidden_dim
        self.mask_embedder0 = Linear(d, d)
        self.mask_embedder1 = Linear(d, d)
        self.mask_embedder2 = Linear(d, cfg.mask_feature_size)

    def forward(self, intermediate, mask_features, target_hw):
        x = F.relu(self.mask_embedder0(intermediate))
        x = F.relu(self.mask_embedder1(x))
        x = self.mask_embedder2(x)
        outputs_mask = torch.einsum("bqc,bhwc->bqhw", x, mask_features)
        th, tw = target_hw
        b, q = outputs_mask.shape[:2]
        am = resize_bilinear(outputs_mask.permute(0, 2, 3, 1), (th, tw)).permute(0, 3, 1, 2)
        am = am.reshape(b, q, th * tw).detach()
        all_blocked = (am < 0.0).all(dim=-1)
        return outputs_mask, (am.float(), all_blocked)


class TransformerModule(nn.Module):
    """multi-scale features + mask features -> per-layer (class logits, mask logits)."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        d, nl = cfg.hidden_dim, cfg.num_feature_levels
        self.level_embed = nn.Parameter(torch.zeros(nl, d))
        self.queries_embedder = nn.Parameter(torch.zeros(cfg.num_queries, d))
        self.queries_features = nn.Parameter(torch.zeros(cfg.num_queries, d))
        self.decoder_layernorm = LayerNorm(d, eps=FLAX_EPS)
        self.mask_predictor = MaskPredictor(cfg)
        self.class_predictor = Linear(d, cfg.num_labels + 1)
        for idx in range(cfg.decoder_layers - 1):
            self.add_module(f"layer{idx}", DecoderLayer(cfg))

    def forward(self, multi_scale_features, mask_features):
        cfg = self.cfg
        d, nl = cfg.hidden_dim, cfg.num_feature_levels
        b = mask_features.shape[0]
        memories, memory_poses, sizes = [], [], []
        for i in range(nl):
            f = multi_scale_features[i]
            h, w = f.shape[1:3]
            sizes.append((h, w))
            memories.append(f.reshape(b, h * w, d) + self.level_embed[i][None, None])
            pos = sine_position_embedding(h, w, d // 2, device=f.device).to(f.dtype)
            memory_poses.append(pos.reshape(1, h * w, d))

        query_pos = self.queries_embedder[None].expand(b, -1, -1)
        hidden = self.queries_features[None].expand(b, -1, -1)

        class_logits_all, mask_logits_all = [], []
        intermediate = self.decoder_layernorm(hidden)
        class_logits_all.append(self.class_predictor(intermediate))
        pred_mask, attn_mask = self.mask_predictor(intermediate, mask_features, sizes[0])
        mask_logits_all.append(pred_mask)
        for idx in range(cfg.decoder_layers - 1):
            lvl = idx % nl
            hidden = getattr(self, f"layer{idx}")(hidden, query_pos, memories[lvl], memory_poses[lvl], attn_mask)
            intermediate = self.decoder_layernorm(hidden)
            class_logits_all.append(self.class_predictor(intermediate))
            pred_mask, attn_mask = self.mask_predictor(intermediate, mask_features, sizes[(idx + 1) % nl])
            mask_logits_all.append(pred_mask)
        return class_logits_all, mask_logits_all
