"""HF Mask2Former checkpoints for the port: read and write them, and carry
their weights onto the port's modules (counterpart of
`rgbdseg_tpu/utils/hf_convert.py`).

The converters are copies of the JAX package's numpy ones: an HF state_dict
(reference: custom_model.py:10-13) to the flax-layout trees {params,
batch_stats} and back (conv OIHW <-> HWIO, dense (out, in) <-> (in, out),
torch nn.MultiheadAttention's in_proj <-> q/k/v), `config_from_hf` and
`hf_config_dict`. The port's module names follow flax's, so
`utils.weights.from_flax` / `to_flax` carry those trees onto the port's
`state_dict` and back; the port's API composes the two:

- `load_hf_checkpoint(dir, version, with_batch_stats)` -> (ModelConfig,
  state_dict): config.json, then model.safetensors (`utils/safetensors.py`)
  or pytorch_model.bin (`torch.load(weights_only=True)`);
- `graft(model, state_dict)` loads every key of matching shape and returns
  the ones it skipped, with both shapes (a class head of another num_labels
  keeps its fresh init); trunk keys the checkpoint lacks are logged;
- `export_hf_checkpoint(model, cfg, out_dir, id2label)` writes config.json
  (with `rgbdseg_version` and `rgbdseg_extras`) and model.safetensors in the
  reference's key layout.
"""

from __future__ import annotations

import json
import logging
import os

import numpy as np
import torch

from .safetensors import load_file, save_file
from .weights import from_flax, to_flax

logger = logging.getLogger(__name__)

def _dense(sd, prefix):
    return {"kernel": sd[prefix + ".weight"].T, "bias": sd[prefix + ".bias"]}


def _dense_nb(sd, prefix):
    return {"kernel": sd[prefix + ".weight"].T}


def _conv(sd, prefix, bias=True):
    out = {"kernel": sd[prefix + ".weight"].transpose(2, 3, 1, 0)}
    if bias:
        out["bias"] = sd[prefix + ".bias"]
    return out


def _ln(sd, prefix):
    return {"scale": sd[prefix + ".weight"], "bias": sd[prefix + ".bias"]}


def convert_swin_backbone(sd: dict, prefix: str, depths) -> dict:
    """HF SwinBackbone state_dict subtree -> SwinBackbone flax params."""
    p = {}
    p["patch_embed"] = _conv(sd, f"{prefix}.embeddings.patch_embeddings.projection")
    p["patch_norm"] = _ln(sd, f"{prefix}.embeddings.norm")
    for s, depth in enumerate(depths):
        for b in range(depth):
            bp = f"{prefix}.encoder.layers.{s}.blocks.{b}"
            blk = {
                "norm1": _ln(sd, f"{bp}.layernorm_before"),
                "norm2": _ln(sd, f"{bp}.layernorm_after"),
                "attention": {
                    "query": _dense(sd, f"{bp}.attention.self.query"),
                    "key": _dense(sd, f"{bp}.attention.self.key"),
                    "value": _dense(sd, f"{bp}.attention.self.value"),
                    "proj": _dense(sd, f"{bp}.attention.output.dense"),
                    "relative_position_bias_table": sd[
                        f"{bp}.attention.self.relative_position_bias_table"
                    ],
                },
                "mlp_fc1": _dense(sd, f"{bp}.intermediate.dense"),
                "mlp_fc2": _dense(sd, f"{bp}.output.dense"),
            }
            p[f"stage{s}_block{b}"] = blk
        if s < len(depths) - 1:
            dp = f"{prefix}.encoder.layers.{s}.downsample"
            p[f"downsample{s}"] = {
                "norm": _ln(sd, f"{dp}.norm"),
                "reduction": _dense_nb(sd, f"{dp}.reduction"),
            }
        p[f"out_norm{s}"] = _ln(sd, f"{prefix}.hidden_states_norms.stage{s + 1}")
    return p


def convert_pixel_decoder(sd: dict, prefix: str, encoder_layers: int, num_fpn: int = 1) -> dict:
    p = {"level_embed": sd[f"{prefix}.level_embed"]}
    for i in range(3):
        p[f"input_proj{i}_conv"] = _conv(sd, f"{prefix}.input_projections.{i}.0")
        gn = f"{prefix}.input_projections.{i}.1"
        p[f"input_proj{i}_norm"] = {"scale": sd[gn + ".weight"], "bias": sd[gn + ".bias"]}
    for li in range(encoder_layers):
        lp = f"{prefix}.encoder.layers.{li}"
        p[f"layer{li}"] = {
            "self_attn": {
                "sampling_offsets": _dense(sd, f"{lp}.self_attn.sampling_offsets"),
                "attention_weights": _dense(sd, f"{lp}.self_attn.attention_weights"),
                "value_proj": _dense(sd, f"{lp}.self_attn.value_proj"),
                "output_proj": _dense(sd, f"{lp}.self_attn.output_proj"),
            },
            "self_attn_layer_norm": _ln(sd, f"{lp}.self_attn_layer_norm"),
            "fc1": _dense(sd, f"{lp}.fc1"),
            "fc2": _dense(sd, f"{lp}.fc2"),
            "final_layer_norm": _ln(sd, f"{lp}.final_layer_norm"),
        }
    for i in range(num_fpn):
        ap = f"{prefix}.adapter_{i + 1}"
        p[f"adapter{i}_conv"] = _conv(sd, f"{ap}.0", bias=False)
        p[f"adapter{i}_norm"] = {"scale": sd[f"{ap}.1.weight"], "bias": sd[f"{ap}.1.bias"]}
        op = f"{prefix}.layer_{i + 1}"
        p[f"fpn{i}_conv"] = _conv(sd, f"{op}.0", bias=False)
        p[f"fpn{i}_norm"] = {"scale": sd[f"{op}.1.weight"], "bias": sd[f"{op}.1.bias"]}
    p["mask_projection"] = _conv(sd, f"{prefix}.mask_projection")
    return p


def _mha_from_torch(sd: dict, prefix: str, d: int) -> dict:
    """torch nn.MultiheadAttention -> q/k/v/out projections."""
    w = sd[f"{prefix}.in_proj_weight"]
    b = sd[f"{prefix}.in_proj_bias"]
    return {
        "q_proj": {"kernel": w[:d].T, "bias": b[:d]},
        "k_proj": {"kernel": w[d : 2 * d].T, "bias": b[d : 2 * d]},
        "v_proj": {"kernel": w[2 * d :].T, "bias": b[2 * d :]},
        "out_proj": _dense(sd, f"{prefix}.out_proj"),
    }


def convert_transformer_module(sd: dict, prefix: str, decoder_layers: int, hidden_dim: int) -> dict:
    p = {
        "queries_embedder": sd[f"{prefix}.queries_embedder.weight"],
        "queries_features": sd[f"{prefix}.queries_features.weight"],
        "level_embed": sd[f"{prefix}.level_embed.weight"],
        "decoder_layernorm": _ln(sd, f"{prefix}.decoder.layernorm"),
        "mask_predictor": {
            f"mask_embedder{i}": _dense(sd, f"{prefix}.decoder.mask_predictor.mask_embedder.{i}.0")
            for i in range(3)
        },
    }
    for li in range(decoder_layers - 1):
        lp = f"{prefix}.decoder.layers.{li}"
        p[f"layer{li}"] = {
            "cross_attn": _mha_from_torch(sd, f"{lp}.cross_attn", hidden_dim),
            "cross_attn_layer_norm": _ln(sd, f"{lp}.cross_attn_layer_norm"),
            "self_attn": {
                "q_proj": _dense(sd, f"{lp}.self_attn.q_proj"),
                "k_proj": _dense(sd, f"{lp}.self_attn.k_proj"),
                "v_proj": _dense(sd, f"{lp}.self_attn.v_proj"),
                "out_proj": _dense(sd, f"{lp}.self_attn.out_proj"),
            },
            "self_attn_layer_norm": _ln(sd, f"{lp}.self_attn_layer_norm"),
            "fc1": _dense(sd, f"{lp}.fc1"),
            "fc2": _dense(sd, f"{lp}.fc2"),
            "final_layer_norm": _ln(sd, f"{lp}.final_layer_norm"),
        }
    return p


def config_from_hf(hf_config: dict):
    """HF Mask2FormerConfig dict (config.json) -> ModelConfig.

    Lets users load any reference-trained checkpoint directory
    (reference checkpoints: mask2former/checkpoints/standard + remote/*)."""
    from ..config import ModelConfig, SwinConfig

    bb = hf_config.get("backbone_config", {}) or {}
    backbone = SwinConfig(
        patch_size=bb.get("patch_size", 4),
        embed_dim=bb.get("embed_dim", 96),
        depths=tuple(bb.get("depths", (2, 2, 6, 2))),
        num_heads=tuple(bb.get("num_heads", (3, 6, 12, 24))),
        window_size=bb.get("window_size", 7),
        mlp_ratio=bb.get("mlp_ratio", 4.0),
        qkv_bias=bb.get("qkv_bias", True),
        drop_path_rate=bb.get("drop_path_rate", 0.3),
        layer_norm_eps=bb.get("layer_norm_eps", 1e-5),
    )
    num_labels = len(hf_config.get("id2label", {})) or 2
    return ModelConfig(
        backbone=backbone,
        num_labels=num_labels,
        feature_size=hf_config.get("feature_size", 256),
        mask_feature_size=hf_config.get("mask_feature_size", 256),
        encoder_layers=hf_config.get("encoder_layers", 6),
        encoder_feedforward_dim=hf_config.get("encoder_feedforward_dim", 1024),
        hidden_dim=hf_config.get("hidden_dim", 256),
        num_queries=hf_config.get("num_queries", 100),
        decoder_layers=hf_config.get("decoder_layers", 10),
        num_attention_heads=hf_config.get("num_attention_heads", 8),
        dim_feedforward=hf_config.get("dim_feedforward", 2048),
        class_weight=hf_config.get("class_weight", 2.0),
        mask_weight=hf_config.get("mask_weight", 5.0),
        dice_weight=hf_config.get("dice_weight", 5.0),
        no_object_weight=hf_config.get("no_object_weight", 0.1),
        train_num_points=hf_config.get("train_num_points", 12544),
        oversample_ratio=hf_config.get("oversample_ratio", 3.0),
        importance_sample_ratio=hf_config.get("importance_sample_ratio", 0.75),
    )




def load_hf_checkpoint(model_dir: str, version: str = "0.0.0", with_batch_stats: bool = True):
    """An HF Mask2Former checkpoint directory (config.json + model.safetensors or
    pytorch_model.bin) -> (ModelConfig, the port's state_dict).

    Stock HF checkpoints cover the shared Mask2Former trunk; the version's fusion
    modules then keep their fresh init under `graft`. Directories written by
    `export_hf_checkpoint` (or a torch save of the reference's custom model)
    carry the fusion weights under `model.pixel_level_module.*`, detected by
    the config's `rgbdseg_version` tag or the custom keys, and their BatchNorm
    running statistics come with them unless `with_batch_stats` is False."""
    with open(os.path.join(model_dir, "config.json")) as f:
        hf_config = json.load(f)
    version = hf_config.get("rgbdseg_version", version)
    cfg = config_from_hf(hf_config).replace(version=version, **hf_config.get("rgbdseg_extras", {}))

    st_path = os.path.join(model_dir, "model.safetensors")
    if os.path.exists(st_path):
        tensors = load_file(st_path)
    else:
        tensors = torch.load(os.path.join(model_dir, "pytorch_model.bin"), map_location="cpu", weights_only=True)
    sd = {k: v.numpy() for k, v in tensors.items()}
    custom_prefixes = (
        "model.pixel_level_module.dsam",
        "model.pixel_level_module.ratio_predictor",
        "model.pixel_level_module.depth_gradient_injection",
        "model.pixel_level_module.feature_fuser",
        "model.pixel_level_module.depth_encoder",
        "model.pixel_level_module.intrinsics_predictor",
    )
    if version != "0.0.0" and any(k.startswith(custom_prefixes) for k in sd):
        params, bs = convert_custom_mask2former(sd, cfg)
    else:
        params, bs = convert_mask2former(sd, cfg), {}
    return cfg, from_flax(params, bs if with_batch_stats else None)


def graft(model: torch.nn.Module, state_dict: dict) -> list[str]:
    """Load every key of `state_dict` whose shape matches the model's; keys of
    another shape keep the model's values and are returned as "name: checkpoint
    (...) vs model (...)" (reference analogue: from_pretrained with another
    num_labels re-initialises the class head). Keys the model lacks are
    skipped and returned too; model keys the checkpoint lacks keep their init
    and are logged."""
    own = model.state_dict()
    take, skipped = {}, []
    for k, v in state_dict.items():
        cur = own.get(k)
        if cur is None:
            skipped.append(f"{k}: not in the model")
        elif tuple(cur.shape) != tuple(v.shape):
            skipped.append(f"{k}: checkpoint {tuple(v.shape)} vs model {tuple(cur.shape)}")
        else:
            take[k] = v
    missing = sorted(set(own) - set(state_dict))
    if missing:
        logger.info("graft: %d model tensors not in the checkpoint keep their init (%s%s)", len(missing),
                    ", ".join(missing[:8]), ", ..." if len(missing) > 8 else "")
    model.load_state_dict(take, strict=False)
    return skipped


def _p(prefix: str) -> str:
    """Join a (possibly empty) state_dict prefix: '' -> '', 'x' -> 'x.'."""
    return prefix + "." if prefix else ""


def _bn_params(sd, prefix):
    return {"scale": sd[prefix + ".weight"], "bias": sd[prefix + ".bias"]}


def _bn_stats(sd, prefix):
    return {"mean": sd[prefix + ".running_mean"], "var": sd[prefix + ".running_var"]}


def convert_dsam(sd: dict, prefix: str, num_regions: int = 3) -> dict:
    """Reference DSAModule (custom_model.py:622-645) -> models.fusion.DSAModule.

    Strided (in != out) modules carry a bias-free rgb_projection; detect it
    from the state_dict rather than taking a flag."""
    p = {f"conv{i}": _conv(sd, f"{_p(prefix)}conv_layers.{i}") for i in range(num_regions + 1)}
    if f"{_p(prefix)}rgb_projection.weight" in sd:
        p["rgb_projection"] = _conv(sd, f"{_p(prefix)}rgb_projection", bias=False)
    return p


def convert_feature_fuser(sd: dict, prefix: str, scales: int = 4) -> dict:
    """Reference FeatureFuser (custom_model.py:505-540)."""
    return {f"fuse{i}": _conv(sd, f"{_p(prefix)}fuse_conv.{i}.0") for i in range(scales)}


def convert_feature_fuser_attn(sd: dict, prefix: str, scales: int = 4) -> dict:
    """Reference FeatureFuserWithSpatialAttention (custom_model.py:567-619)."""
    p = {f"fuse{i}": _conv(sd, f"{_p(prefix)}fuse_conv.{i}.0") for i in range(scales)}
    for i in range(scales):
        p[f"spatial_attention{i}"] = {"conv": _conv(sd, f"{_p(prefix)}spatial_attentions.{i}.conv")}
    return p


def convert_dggm(sd: dict, prefix: str, kind: str, scales: int = 4) -> dict:
    """Reference DepthGradientInjection{,WithMask,Residual} (custom_model.py:
    1009-1269) -> models.fusion DGGM variants."""
    if kind == "residual":
        return {
            f"enhance{i}": _conv(sd, f"{_p(prefix)}depth_enhancement_layers.{i}.0")
            for i in range(scales)
        }
    return {f"fusion{i}": _conv(sd, f"{_p(prefix)}fusion_layers.{i}.0") for i in range(scales)}


def convert_ratio_predictor(sd: dict, prefix: str) -> dict:
    """Reference RatioPredictor (custom_model.py:823-897): fc at .0/.2/.4."""
    return {f"fc{i}": _dense(sd, f"{_p(prefix)}fc_layers.{j}") for i, j in enumerate((0, 2, 4))}


def convert_intrinsics_predictor(sd: dict, prefix: str) -> dict:
    """Reference IntrinsicsPredictorFromDepthImage (custom_model.py:900-1006)."""
    p = {f"conv{i}": _conv(sd, f"{_p(prefix)}conv_backbone.{j}") for i, j in enumerate((0, 2, 4))}
    p.update({f"fc{i}": _dense(sd, f"{_p(prefix)}fc_layers.{j}") for i, j in enumerate((0, 2, 4))})
    return p


def convert_depth_image_ratio_predictor(sd: dict, prefix: str) -> tuple[dict, dict]:
    """Reference DepthImageRatioPredictor (custom_model.py:1272-1360).

    Returns (params, batch_stats): torch BatchNorm2d running stats map to the
    flax `batch_stats` collection."""
    fe = f"{_p(prefix)}depth_feature_extractor"
    p, bs = {}, {}
    for i, j in enumerate((0, 4, 8, 12)):
        p[f"conv{i}"] = _conv(sd, f"{fe}.{j}")
        p[f"bn{i}"] = _bn_params(sd, f"{fe}.{j + 1}")
        bs[f"bn{i}"] = _bn_stats(sd, f"{fe}.{j + 1}")
    for i, j in enumerate((0, 3, 6)):
        p[f"fc{i}"] = _dense(sd, f"{_p(prefix)}fc_layers.{j}")
    return p, bs


def convert_enhanced_ratio_predictor(sd: dict, prefix: str) -> tuple[dict, dict]:
    """Reference EnhancedDepthImageRatioPredictor (custom_model.py:1363-1487).

    Returns (params, batch_stats). The three per-branch BatchNorms
    (scale{1,2,3}_conv.1) concatenate into the single `scales_bn` over the
    192-channel concat — bit-identical math (BN statistics are per-channel);
    this doubles as the migration recipe for pre-rename checkpoints."""
    p, bs = {}, {}
    for i in range(3):
        p[f"scale{i}_conv"] = _conv(sd, f"{_p(prefix)}scale{i + 1}_conv.0")
    cat = lambda key: np.concatenate(  # noqa: E731
        [sd[f"{_p(prefix)}scale{i + 1}_conv.1.{key}"] for i in range(3)]
    )
    p["scales_bn"] = {"scale": cat("weight"), "bias": cat("bias")}
    bs["scales_bn"] = {"mean": cat("running_mean"), "var": cat("running_var")}
    p["fusion_conv"] = _conv(sd, f"{_p(prefix)}feature_fusion.0")
    p["fusion_bn"] = _bn_params(sd, f"{_p(prefix)}feature_fusion.1")
    bs["fusion_bn"] = _bn_stats(sd, f"{_p(prefix)}feature_fusion.1")
    p["attn_conv0"] = _conv(sd, f"{_p(prefix)}attention.0")
    p["attn_conv1"] = _conv(sd, f"{_p(prefix)}attention.2")
    for i, j in enumerate((0, 4)):
        p[f"extract_conv{i}"] = _conv(sd, f"{_p(prefix)}feature_extractor.{j}")
        p[f"extract_bn{i}"] = _bn_params(sd, f"{_p(prefix)}feature_extractor.{j + 1}")
        bs[f"extract_bn{i}"] = _bn_stats(sd, f"{_p(prefix)}feature_extractor.{j + 1}")
    for i, j in enumerate((0, 3, 6, 8)):
        p[f"fc{i}"] = _dense(sd, f"{_p(prefix)}fc_layers.{j}")
    return p, bs


def convert_pixel_level_module(state_dict: dict, cfg) -> tuple[dict, dict]:
    """Reference CustomMask2FormerPixelLevelModule state_dict (bare module:
    keys 'encoder.*', 'decoder.*', 'dsam0.*', ...; custom_model.py:56-141) ->
    (params, batch_stats) for models.mask2former.PixelLevelModule at the same
    version. Covers every fusion attribute the constructor can create."""
    sd = {k: np.asarray(v) for k, v in state_dict.items()}
    from ..versions import get as get_version

    fusion = get_version(cfg.version).fusion
    p: dict = {
        "encoder": convert_swin_backbone(sd, "encoder", cfg.backbone.depths),
        "pixel_decoder": convert_pixel_decoder(sd, "decoder", cfg.encoder_layers),
    }
    bs: dict = {}
    if fusion.dual_backbone:
        p["depth_encoder"] = convert_swin_backbone(sd, "depth_encoder", cfg.backbone.depths)
    if fusion.dsam:
        p["dsam_cascade"] = {
            f"dsam{k}": convert_dsam(sd, f"dsam{k}", cfg.dsam_num_regions) for k in range(3)
        }
    if fusion.ratio == "backbone":
        p["ratio_predictor"] = convert_ratio_predictor(sd, "ratio_predictor")
    elif fusion.ratio == "enhanced":
        p["ratio_predictor"], rbs = convert_enhanced_ratio_predictor(sd, "ratio_predictor")
        bs["ratio_predictor"] = rbs
    if fusion.dggm is not None:
        p["dggm"] = convert_dggm(sd, "depth_gradient_injection", fusion.dggm)
    if fusion.feature_fuser:
        p["feature_fuser"] = convert_feature_fuser(sd, "feature_fuser")
    if fusion.intrinsics_normals:
        p["intrinsics_predictor"] = convert_intrinsics_predictor(sd, "intrinsics_predictor")
    return p, bs


def convert_custom_mask2former(state_dict: dict, cfg) -> tuple[dict, dict]:
    """Reference CustomMask2FormerForUniversalSegmentation state_dict (any
    fusion version; custom_model.py:45-54 wraps the custom pixel-level module
    with the stock transformer module + class head) -> (params, batch_stats)
    for models.mask2former.Mask2FormerRGBD at the same cfg.version."""
    prefix = "model.pixel_level_module."
    plm_sd = {k[len(prefix) :]: v for k, v in state_dict.items() if k.startswith(prefix)}
    plm, plm_bs = convert_pixel_level_module(plm_sd, cfg)
    sd = {k: np.asarray(v) for k, v in state_dict.items()}
    params = {
        "pixel_level_module": plm,
        "transformer_module": {
            **convert_transformer_module(
                sd, "model.transformer_module", cfg.decoder_layers, cfg.hidden_dim
            ),
            "class_predictor": _dense(sd, "class_predictor"),
        },
    }
    return params, ({"pixel_level_module": plm_bs} if plm_bs else {})


# ---------------------------------------------------------------------------
# Flax-layout trees -> HF export (inverse of the converters above).
#
# The reference's training artifact is an HF checkpoint directory any torch
# stack can `from_pretrained` (reference finetuning.py:114-117 saves via the
# HF Trainer; custom_model.py:45-53 reloads it); `export_hf_checkpoint`
# writes the same, so a model the port trains goes back to that ecosystem and
# to the JAX package (tests/test_torch_hf.py holds the round trips).
# ---------------------------------------------------------------------------


def _np32(a) -> np.ndarray:
    return np.asarray(a)


def _x_dense(sd, prefix, p, bias=True):
    sd[prefix + ".weight"] = _np32(p["kernel"]).T
    if bias:
        sd[prefix + ".bias"] = _np32(p["bias"])


def _x_conv(sd, prefix, p):
    sd[prefix + ".weight"] = _np32(p["kernel"]).transpose(3, 2, 0, 1)
    if "bias" in p:
        sd[prefix + ".bias"] = _np32(p["bias"])


def _x_ln(sd, prefix, p):
    sd[prefix + ".weight"] = _np32(p["scale"])
    sd[prefix + ".bias"] = _np32(p["bias"])


def _x_bn(sd, prefix, p, stats):
    sd[prefix + ".weight"] = _np32(p["scale"])
    sd[prefix + ".bias"] = _np32(p["bias"])
    sd[prefix + ".running_mean"] = _np32(stats["mean"])
    sd[prefix + ".running_var"] = _np32(stats["var"])
    sd[prefix + ".num_batches_tracked"] = np.asarray(0, np.int64)


def _x_mha(sd, prefix, p):
    """q/k/v/out projections -> torch nn.MultiheadAttention in_proj layout."""
    sd[prefix + ".in_proj_weight"] = np.concatenate(
        [_np32(p[k]["kernel"]).T for k in ("q_proj", "k_proj", "v_proj")], axis=0
    )
    sd[prefix + ".in_proj_bias"] = np.concatenate(
        [_np32(p[k]["bias"]) for k in ("q_proj", "k_proj", "v_proj")]
    )
    _x_dense(sd, prefix + ".out_proj", p["out_proj"])


def export_swin_backbone(sd: dict, prefix: str, p: dict, depths) -> None:
    _x_conv(sd, f"{prefix}.embeddings.patch_embeddings.projection", p["patch_embed"])
    _x_ln(sd, f"{prefix}.embeddings.norm", p["patch_norm"])
    for s, depth in enumerate(depths):
        for b in range(depth):
            bp = f"{prefix}.encoder.layers.{s}.blocks.{b}"
            blk = p[f"stage{s}_block{b}"]
            _x_ln(sd, f"{bp}.layernorm_before", blk["norm1"])
            _x_ln(sd, f"{bp}.layernorm_after", blk["norm2"])
            at = blk["attention"]
            _x_dense(sd, f"{bp}.attention.self.query", at["query"])
            _x_dense(sd, f"{bp}.attention.self.key", at["key"])
            _x_dense(sd, f"{bp}.attention.self.value", at["value"])
            _x_dense(sd, f"{bp}.attention.output.dense", at["proj"])
            sd[f"{bp}.attention.self.relative_position_bias_table"] = _np32(
                at["relative_position_bias_table"]
            )
            _x_dense(sd, f"{bp}.intermediate.dense", blk["mlp_fc1"])
            _x_dense(sd, f"{bp}.output.dense", blk["mlp_fc2"])
        if s < len(depths) - 1:
            dp = f"{prefix}.encoder.layers.{s}.downsample"
            _x_ln(sd, f"{dp}.norm", p[f"downsample{s}"]["norm"])
            _x_dense(sd, f"{dp}.reduction", p[f"downsample{s}"]["reduction"], bias=False)
        _x_ln(sd, f"{prefix}.hidden_states_norms.stage{s + 1}", p[f"out_norm{s}"])


def export_pixel_decoder(sd: dict, prefix: str, p: dict, encoder_layers: int, num_fpn: int = 1) -> None:
    sd[f"{prefix}.level_embed"] = _np32(p["level_embed"])
    for i in range(3):
        _x_conv(sd, f"{prefix}.input_projections.{i}.0", p[f"input_proj{i}_conv"])
        _x_ln(sd, f"{prefix}.input_projections.{i}.1", p[f"input_proj{i}_norm"])
    for li in range(encoder_layers):
        lp, lyr = f"{prefix}.encoder.layers.{li}", p[f"layer{li}"]
        for k in ("sampling_offsets", "attention_weights", "value_proj", "output_proj"):
            _x_dense(sd, f"{lp}.self_attn.{k}", lyr["self_attn"][k])
        _x_ln(sd, f"{lp}.self_attn_layer_norm", lyr["self_attn_layer_norm"])
        _x_dense(sd, f"{lp}.fc1", lyr["fc1"])
        _x_dense(sd, f"{lp}.fc2", lyr["fc2"])
        _x_ln(sd, f"{lp}.final_layer_norm", lyr["final_layer_norm"])
    for i in range(num_fpn):
        _x_conv(sd, f"{prefix}.adapter_{i + 1}.0", p[f"adapter{i}_conv"])
        _x_ln(sd, f"{prefix}.adapter_{i + 1}.1", p[f"adapter{i}_norm"])
        _x_conv(sd, f"{prefix}.layer_{i + 1}.0", p[f"fpn{i}_conv"])
        _x_ln(sd, f"{prefix}.layer_{i + 1}.1", p[f"fpn{i}_norm"])
    _x_conv(sd, f"{prefix}.mask_projection", p["mask_projection"])


def export_transformer_module(sd: dict, prefix: str, p: dict, decoder_layers: int) -> None:
    sd[f"{prefix}.queries_embedder.weight"] = _np32(p["queries_embedder"])
    sd[f"{prefix}.queries_features.weight"] = _np32(p["queries_features"])
    sd[f"{prefix}.level_embed.weight"] = _np32(p["level_embed"])
    _x_ln(sd, f"{prefix}.decoder.layernorm", p["decoder_layernorm"])
    for i in range(3):
        _x_dense(
            sd,
            f"{prefix}.decoder.mask_predictor.mask_embedder.{i}.0",
            p["mask_predictor"][f"mask_embedder{i}"],
        )
    for li in range(decoder_layers - 1):
        lp, lyr = f"{prefix}.decoder.layers.{li}", p[f"layer{li}"]
        _x_mha(sd, f"{lp}.cross_attn", lyr["cross_attn"])
        _x_ln(sd, f"{lp}.cross_attn_layer_norm", lyr["cross_attn_layer_norm"])
        for k in ("q_proj", "k_proj", "v_proj", "out_proj"):
            _x_dense(sd, f"{lp}.self_attn.{k}", lyr["self_attn"][k])
        _x_ln(sd, f"{lp}.self_attn_layer_norm", lyr["self_attn_layer_norm"])
        _x_dense(sd, f"{lp}.fc1", lyr["fc1"])
        _x_dense(sd, f"{lp}.fc2", lyr["fc2"])
        _x_ln(sd, f"{lp}.final_layer_norm", lyr["final_layer_norm"])


def _export_fusion_modules(sd: dict, prefix: str, plm: dict, plm_bs: dict, cfg) -> None:
    """Version-specific fusion modules -> the reference CustomMask2Former
    attribute names (custom_model.py:56-141)."""
    from ..versions import get as get_version

    fusion = get_version(cfg.version).fusion
    pfx = _p(prefix)
    if fusion.dsam:
        for k in range(3):
            dsam = plm["dsam_cascade"][f"dsam{k}"]
            for i in range(cfg.dsam_num_regions + 1):
                _x_conv(sd, f"{pfx}dsam{k}.conv_layers.{i}", dsam[f"conv{i}"])
            if "rgb_projection" in dsam:
                _x_conv(sd, f"{pfx}dsam{k}.rgb_projection", dsam["rgb_projection"])
    if fusion.ratio == "backbone":
        for i, j in enumerate((0, 2, 4)):
            _x_dense(sd, f"{pfx}ratio_predictor.fc_layers.{j}", plm["ratio_predictor"][f"fc{i}"])
    elif fusion.ratio == "enhanced":
        rp, rbs = plm["ratio_predictor"], plm_bs.get("ratio_predictor", {})
        third = _np32(rp["scales_bn"]["scale"]).shape[0] // 3
        for i in range(3):
            _x_conv(sd, f"{pfx}ratio_predictor.scale{i + 1}_conv.0", rp[f"scale{i}_conv"])
            sl = slice(i * third, (i + 1) * third)
            bp = f"{pfx}ratio_predictor.scale{i + 1}_conv.1"
            sd[bp + ".weight"] = _np32(rp["scales_bn"]["scale"])[sl]
            sd[bp + ".bias"] = _np32(rp["scales_bn"]["bias"])[sl]
            sd[bp + ".running_mean"] = _np32(rbs["scales_bn"]["mean"])[sl]
            sd[bp + ".running_var"] = _np32(rbs["scales_bn"]["var"])[sl]
            sd[bp + ".num_batches_tracked"] = np.asarray(0, np.int64)
        _x_conv(sd, f"{pfx}ratio_predictor.feature_fusion.0", rp["fusion_conv"])
        _x_bn(sd, f"{pfx}ratio_predictor.feature_fusion.1", rp["fusion_bn"], rbs["fusion_bn"])
        _x_conv(sd, f"{pfx}ratio_predictor.attention.0", rp["attn_conv0"])
        _x_conv(sd, f"{pfx}ratio_predictor.attention.2", rp["attn_conv1"])
        for i, j in enumerate((0, 4)):
            _x_conv(sd, f"{pfx}ratio_predictor.feature_extractor.{j}", rp[f"extract_conv{i}"])
            _x_bn(
                sd,
                f"{pfx}ratio_predictor.feature_extractor.{j + 1}",
                rp[f"extract_bn{i}"],
                rbs[f"extract_bn{i}"],
            )
        for i, j in enumerate((0, 3, 6, 8)):
            _x_dense(sd, f"{pfx}ratio_predictor.fc_layers.{j}", rp[f"fc{i}"])
    if fusion.dggm is not None:
        key, sub = (
            ("depth_enhancement_layers", "enhance")
            if fusion.dggm == "residual"
            else ("fusion_layers", "fusion")
        )
        for i in range(4):
            _x_conv(sd, f"{pfx}depth_gradient_injection.{key}.{i}.0", plm["dggm"][f"{sub}{i}"])
    if fusion.feature_fuser:
        for i in range(4):
            _x_conv(sd, f"{pfx}feature_fuser.fuse_conv.{i}.0", plm["feature_fuser"][f"fuse{i}"])
    if fusion.intrinsics_normals:
        ip = plm["intrinsics_predictor"]
        for i, j in enumerate((0, 2, 4)):
            _x_conv(sd, f"{pfx}intrinsics_predictor.conv_backbone.{j}", ip[f"conv{i}"])
            _x_dense(sd, f"{pfx}intrinsics_predictor.fc_layers.{j}", ip[f"fc{i}"])


def export_state_dict(params: dict, batch_stats: dict, cfg) -> dict:
    """Flax (params, batch_stats) -> reference torch state_dict
    {name: np.ndarray} for CustomMask2FormerForUniversalSegmentation at
    cfg.version (stock HF Mask2Former keys for version 0.0.0). Exact inverse
    of convert_custom_mask2former / convert_mask2former; tensors keep their
    dtype (cast f32 upstream if needed)."""
    sd: dict[str, np.ndarray] = {}
    plm = params["pixel_level_module"]
    plm_bs = (batch_stats or {}).get("pixel_level_module", {})
    export_swin_backbone(sd, "model.pixel_level_module.encoder", plm["encoder"], cfg.backbone.depths)
    if "depth_encoder" in plm:
        export_swin_backbone(
            sd, "model.pixel_level_module.depth_encoder", plm["depth_encoder"], cfg.backbone.depths
        )
    export_pixel_decoder(
        sd, "model.pixel_level_module.decoder", plm["pixel_decoder"], cfg.encoder_layers
    )
    _export_fusion_modules(sd, "model.pixel_level_module", plm, plm_bs, cfg)
    tm = params["transformer_module"]
    export_transformer_module(sd, "model.transformer_module", tm, cfg.decoder_layers)
    _x_dense(sd, "class_predictor", tm["class_predictor"])
    # HF registers the criterion's CE class-weight vector as a persistent
    # buffer (modeling_mask2former Mask2FormerLoss.empty_weight); ours lives
    # in ops/losses.py as config-derived math — reconstruct it for the torch
    # state_dict.
    sd["criterion.empty_weight"] = np.concatenate(
        [np.ones((cfg.num_labels,), np.float32), np.asarray([cfg.no_object_weight], np.float32)]
    )
    return sd


def hf_config_dict(cfg, id2label: dict | None = None) -> dict:
    """ModelConfig -> HF Mask2FormerConfig JSON dict (inverse of
    config_from_hf). The JAX package serialises it through transformers'
    Mask2FormerConfig where that is installed, which adds the class's other
    fields with their defaults; the port writes these fields alone
    (transformers' `from_pretrained` fills in the rest)."""
    id2label = id2label or {i: str(i) for i in range(cfg.num_labels)}
    bb = dict(
        model_type="swin",
        patch_size=cfg.backbone.patch_size,
        embed_dim=cfg.backbone.embed_dim,
        depths=list(cfg.backbone.depths),
        num_heads=list(cfg.backbone.num_heads),
        window_size=cfg.backbone.window_size,
        mlp_ratio=cfg.backbone.mlp_ratio,
        qkv_bias=cfg.backbone.qkv_bias,
        drop_path_rate=cfg.backbone.drop_path_rate,
        layer_norm_eps=cfg.backbone.layer_norm_eps,
        out_features=["stage1", "stage2", "stage3", "stage4"],
    )
    core = dict(
        model_type="mask2former",
        architectures=["Mask2FormerForUniversalSegmentation"],
        backbone_config=bb,
        feature_size=cfg.feature_size,
        mask_feature_size=cfg.mask_feature_size,
        encoder_layers=cfg.encoder_layers,
        encoder_feedforward_dim=cfg.encoder_feedforward_dim,
        hidden_dim=cfg.hidden_dim,
        num_queries=cfg.num_queries,
        decoder_layers=cfg.decoder_layers,
        num_attention_heads=cfg.num_attention_heads,
        dim_feedforward=cfg.dim_feedforward,
        class_weight=cfg.class_weight,
        mask_weight=cfg.mask_weight,
        dice_weight=cfg.dice_weight,
        no_object_weight=cfg.no_object_weight,
        train_num_points=cfg.train_num_points,
        oversample_ratio=cfg.oversample_ratio,
        importance_sample_ratio=cfg.importance_sample_ratio,
        use_auxiliary_loss=cfg.use_auxiliary_loss,
        init_std=cfg.init_std,
        init_xavier_std=cfg.init_xavier_std,
        id2label={int(k): v for k, v in id2label.items()},
        label2id={v: int(k) for k, v in id2label.items()},
    )
    return core


def export_hf_checkpoint(model: torch.nn.Module, cfg, out_dir: str, id2label=None) -> str:
    """Write an HF checkpoint directory (config.json + model.safetensors) of
    `model`'s weights that the reference stack can `from_pretrained`
    (custom_model.py:45-53). Returns out_dir. config.json also carries
    `rgbdseg_version` and the DSAM settings (`rgbdseg_extras`), so the fusion
    topology and the exact ModelConfig are rebuilt on reload."""
    os.makedirs(out_dir, exist_ok=True)
    params, batch_stats = to_flax(model.state_dict())
    sd = {k: np.ascontiguousarray(v) for k, v in export_state_dict(params, batch_stats, cfg).items()}
    conf = hf_config_dict(cfg, id2label)
    conf["rgbdseg_version"] = cfg.version
    conf["rgbdseg_extras"] = {
        "dsam_num_regions": cfg.dsam_num_regions,
        "dsam_hist_bins": cfg.dsam_hist_bins,
        "dsam_prominence": cfg.dsam_prominence,
        "dsam_default_ratio": cfg.dsam_default_ratio,
    }
    with open(os.path.join(out_dir, "config.json"), "w") as f:
        json.dump(conf, f, indent=2, sort_keys=True, default=str)
    save_file(sd, os.path.join(out_dir, "model.safetensors"), metadata={"format": "pt"})
    return out_dir


def convert_mask2former(state_dict: dict, cfg) -> dict:
    """Full HF Mask2FormerForUniversalSegmentation state_dict -> flax params."""
    sd = {k: np.asarray(v) for k, v in state_dict.items()}
    params = {
        "pixel_level_module": {
            "encoder": convert_swin_backbone(
                sd, "model.pixel_level_module.encoder", cfg.backbone.depths
            ),
            "pixel_decoder": convert_pixel_decoder(
                sd, "model.pixel_level_module.decoder", cfg.encoder_layers
            ),
        },
        "transformer_module": {
            **convert_transformer_module(
                sd, "model.transformer_module", cfg.decoder_layers, cfg.hidden_dim
            ),
            "class_predictor": _dense(sd, "class_predictor"),
        },
    }
    return params
