"""Typed configuration for the Mask2Former RGB-D model (PyTorch port).

A copy of `rgbdseg_tpu/config.py`: the port keeps its own copy so that it
imports nothing of the JAX package.

Mirrors the capability surface of the upstream repository's configs:
- model hyperparameters: `mask2former/checkpoints/standard/config.json`
- preprocessing: `mask2former/checkpoints/standard/preprocessor_config.json`
The version registry (fusion architecture x channel layout) lives in
`rgbdseg_torch.versions`.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Sequence


@dataclasses.dataclass(frozen=True)
class SwinConfig:
    """Swin Transformer backbone config (Swin-T defaults).

    Matches the backbone_config of the reference checkpoint
    (reference: mask2former/checkpoints/standard/config.json backbone_config).
    """

    num_channels: int = 3
    patch_size: int = 4
    embed_dim: int = 96
    depths: tuple[int, ...] = (2, 2, 6, 2)
    num_heads: tuple[int, ...] = (3, 6, 12, 24)
    window_size: int = 7
    mlp_ratio: float = 4.0
    qkv_bias: bool = True
    drop_path_rate: float = 0.3
    hidden_dropout: float = 0.0
    attention_dropout: float = 0.0
    layer_norm_eps: float = 1e-5
    patch_norm: bool = True

    @property
    def num_layers(self) -> int:
        return len(self.depths)

    @property
    def feature_channels(self) -> tuple[int, ...]:
        return tuple(self.embed_dim * (2**i) for i in range(self.num_layers))


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Mask2Former model config.

    Field semantics follow the reference's HF config
    (reference: mask2former/checkpoints/standard/config.json); all defaults are the
    values used by the reference experiments.
    """

    backbone: SwinConfig = dataclasses.field(default_factory=SwinConfig)
    num_labels: int = 2

    # Pixel decoder (multi-scale deformable attention encoder).
    feature_size: int = 256
    mask_feature_size: int = 256
    encoder_layers: int = 6
    encoder_feedforward_dim: int = 1024
    num_feature_levels: int = 3  # deformable levels (strides 8/16/32)
    deformable_points: int = 4
    feature_strides: tuple[int, ...] = (4, 8, 16, 32)
    common_stride: int = 4

    # Transformer decoder.
    hidden_dim: int = 256
    num_queries: int = 100
    decoder_layers: int = 10  # 1 initial prediction + (decoder_layers - 1) blocks
    num_attention_heads: int = 8
    dim_feedforward: int = 2048
    pre_norm: bool = False
    activation: str = "relu"
    dropout: float = 0.0

    # Losses.
    class_weight: float = 2.0
    mask_weight: float = 5.0
    dice_weight: float = 5.0
    no_object_weight: float = 0.1
    train_num_points: int = 12544
    oversample_ratio: float = 3.0
    importance_sample_ratio: float = 0.75
    use_auxiliary_loss: bool = True

    init_std: float = 0.02
    init_xavier_std: float = 1.0

    # Fusion architecture version (see rgbdseg_torch.versions).
    version: str = "0.0.0"

    # DSAM decomposition (reference: custom_model.py:622-820).
    dsam_num_regions: int = 3
    dsam_hist_bins: int = 512
    dsam_prominence: float = 0.01
    dsam_default_ratio: float = 0.1

    def replace(self, **kw: Any) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    @staticmethod
    def tiny(num_labels: int = 2, version: str = "0.0.0") -> "ModelConfig":
        """A small config for tests: same topology, fewer layers/channels."""
        return ModelConfig(
            backbone=SwinConfig(embed_dim=32, depths=(1, 1, 1, 1), num_heads=(2, 2, 4, 4), drop_path_rate=0.0),
            num_labels=num_labels,
            feature_size=64,
            mask_feature_size=64,
            encoder_layers=1,
            encoder_feedforward_dim=64,
            hidden_dim=64,
            num_queries=10,
            decoder_layers=4,
            num_attention_heads=4,
            dim_feedforward=64,
            train_num_points=64,
            dsam_hist_bins=64,
            version=version,
        )

    def to_json(self) -> str:
        def _convert(o):
            if dataclasses.is_dataclass(o):
                return dataclasses.asdict(o)
            return o

        return json.dumps(dataclasses.asdict(self), default=_convert, indent=2)

    @staticmethod
    def from_json(text: str) -> "ModelConfig":
        raw = json.loads(text)
        backbone = raw.pop("backbone", None)
        cfg_kwargs = {}
        for f in dataclasses.fields(ModelConfig):
            if f.name in raw:
                v = raw[f.name]
                cfg_kwargs[f.name] = tuple(v) if isinstance(v, list) else v
        if backbone is not None:
            bb_kwargs = {}
            for f in dataclasses.fields(SwinConfig):
                if f.name in backbone:
                    v = backbone[f.name]
                    bb_kwargs[f.name] = tuple(v) if isinstance(v, list) else v
            cfg_kwargs["backbone"] = SwinConfig(**bb_kwargs)
        return ModelConfig(**cfg_kwargs)


@dataclasses.dataclass(frozen=True)
class PreprocessConfig:
    """Image preprocessing config with documented parity to the reference's
    Mask2FormerImageProcessor (reference: standard/preprocessor_config.json):
    bilinear resize (resample=2), rescale 1/255, ImageNet mean/std, size_divisor 32.
    """

    height: int = 256
    width: int = 256
    image_mean: tuple[float, float, float] = (0.485, 0.456, 0.406)
    image_std: tuple[float, float, float] = (0.229, 0.224, 0.225)
    rescale_factor: float = 1.0 / 255.0
    size_divisor: int = 32
    do_resize: bool = True
    do_rescale: bool = True
    do_normalize: bool = True
    ignore_index: int | None = None
    do_reduce_labels: bool = False
