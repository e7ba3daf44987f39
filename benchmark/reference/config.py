"""The reference's model configuration, read from a benchmark configuration
file (`benchmark/configs/<name>.json`): the port's `ModelConfig` field names,
with Swin's under "backbone"."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Swin:
    embed_dim: int = 96
    depths: tuple = (2, 2, 6, 2)
    num_heads: tuple = (3, 6, 12, 24)
    window_size: int = 7
    patch_size: int = 4
    mlp_ratio: float = 4.0
    qkv_bias: bool = True
    drop_path_rate: float = 0.3
    layer_norm_eps: float = 1e-5

    @property
    def channels(self) -> tuple:
        return tuple(self.embed_dim * 2**i for i in range(len(self.depths)))


@dataclasses.dataclass(frozen=True)
class Config:
    backbone: Swin = Swin()
    version: str = "0.4.0"
    num_labels: int = 40
    feature_size: int = 256
    mask_feature_size: int = 256
    encoder_layers: int = 6
    encoder_feedforward_dim: int = 1024
    num_feature_levels: int = 3
    deformable_points: int = 4
    feature_strides: tuple = (4, 8, 16, 32)
    common_stride: int = 4
    hidden_dim: int = 256
    num_queries: int = 100
    decoder_layers: int = 10
    num_attention_heads: int = 8
    dim_feedforward: int = 2048
    class_weight: float = 2.0
    mask_weight: float = 5.0
    dice_weight: float = 5.0
    no_object_weight: float = 0.1
    train_num_points: int = 12544
    oversample_ratio: float = 3.0
    importance_sample_ratio: float = 0.75
    dsam_num_regions: int = 3
    dsam_hist_bins: int = 512
    dsam_prominence: float = 0.01
    dsam_default_ratio: float = 0.1

    @property
    def channels_in(self) -> int:
        return {"0.0.0": 3, "0.4.0": 10}[self.version]

    @staticmethod
    def from_dict(raw: dict) -> "Config":
        def pick(cls, d):
            names = {f.name for f in dataclasses.fields(cls)}
            return {k: tuple(v) if isinstance(v, list) else v for k, v in d.items() if k in names}

        kw = pick(Config, raw)
        kw.pop("backbone", None)
        if raw.get("version", "0.4.0") not in ("0.0.0", "0.4.0"):
            raise ValueError(f"the reference models versions 0.0.0 and 0.4.0, not {raw['version']!r}")
        return Config(backbone=Swin(**pick(Swin, raw.get("backbone", {}))), **kw)
