"""Version registry: the central extension mechanism binding data channel layouts
to fusion architectures.

A copy of `rgbdseg_tpu/versions.py`, kept in the port so that it imports nothing
of the JAX package. The port builds every version.

The reference drives both its dataloader and its model construction off a single
version string (reference: mask2former/utils/dataloader.py:431-537 and
mask2former/utils/custom_model.py:56-381). We reproduce that capability as a typed
registry validated at import time: each version declares its channel layout
(`ChannelSpec`) and its fusion architecture (`FusionSpec`), and the model + input
pipeline both consume the same entry, so layout mismatches are impossible.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ChannelSpec:
    """Slices into the channels-last pixel_values tensor (B, H, W, C_total)."""

    total: int
    rgb: tuple[int, int] = (0, 3)
    depth: Optional[tuple[int, int]] = None  # 3-channel depth image (normalized)
    gradient: Optional[tuple[int, int]] = None  # 3-channel gradient-depth
    gradient_mask: Optional[tuple[int, int]] = None  # 1-channel validity mask
    gray_depth: Optional[tuple[int, int]] = None  # 1-channel raw gray depth
    fused_depth: Optional[tuple[int, int]] = None  # 3-channel CSF-fused depth
    modalities: Optional[tuple[int, int]] = None  # extra augmentation modalities

    def slice(self, name: str):
        rng = getattr(self, name)
        if rng is None:
            raise KeyError(f"channel group {name!r} not present in this spec")
        return slice(rng[0], rng[1])


@dataclasses.dataclass(frozen=True)
class FusionSpec:
    """Which fusion modules are built and how the forward composes them.

    Mirrors the architecture dispatch of the reference pixel-level module
    (reference: custom_model.py:63-141 constructor, :145-381 forward).
    """

    # DGGM variant: None | "inject" (v1) | "inject_mask" (v2) | "residual" (v3)
    dggm: Optional[str] = None
    # What drives DGGM: "gradient" channels, or "normals" computed in-forward (0.0.7)
    dggm_source: str = "gradient"
    # Dual Swin backbone on depth channels
    dual_backbone: bool = False
    # FeatureFuser (concat + 1x1 conv + relu) across color/depth pyramids
    feature_fuser: bool = False
    # 3-stage DSAM cascade
    dsam: bool = False
    # What depth the DSAM decomposition consumes: "depth" | "fused_depth"
    dsam_source: str = "depth"
    # Ratio source: "fixed" | "backbone" (RatioPredictor over depth pyramid)
    #   | "enhanced" (EnhancedDepthImageRatioPredictor over depth image)
    ratio: str = "fixed"
    # Intrinsics predictor + surface normals computed in-forward (version 0.0.7)
    intrinsics_normals: bool = False
    # version 0.4.0: DSAM and DGGM run on detached copies and are summed
    two_branch_sum: bool = False


@dataclasses.dataclass(frozen=True)
class VersionEntry:
    channels: ChannelSpec
    fusion: FusionSpec
    map_fn: str  # name of the map function in data.registry (the port builds map_3channel and map_10channel_case2)


def _e(channels: ChannelSpec, fusion: FusionSpec, map_fn: str) -> VersionEntry:
    return VersionEntry(channels=channels, fusion=fusion, map_fn=map_fn)


# Version table mirroring reference dataloader.py:431-537 + custom_model.py:63-141.
REGISTRY: dict[str, VersionEntry] = {
    # RGB only, stock encoder.
    "0.0.0": _e(ChannelSpec(total=3), FusionSpec(), "map_3channel"),
    # RGB + gradient-depth; DGGM v1 concat-inject.
    "0.0.1": _e(
        ChannelSpec(total=6, gradient=(3, 6)),
        FusionSpec(dggm="inject"),
        "map_6channel",
    ),
    # RGB + gradient-depth + mask; DGGM v2 (concat incl. mask channel).
    "0.0.2": _e(
        ChannelSpec(total=7, gradient=(3, 6), gradient_mask=(6, 7)),
        FusionSpec(dggm="inject_mask"),
        "map_7channel_tmp",
    ),
    # RGB + gradient-depth + mask; DGGM v3 gated residual.
    "0.0.3": _e(
        ChannelSpec(total=7, gradient=(3, 6), gradient_mask=(6, 7)),
        FusionSpec(dggm="residual"),
        "map_7channel_tmp",
    ),
    "0.0.4": _e(
        ChannelSpec(total=7, gradient=(3, 6), gradient_mask=(6, 7)),
        FusionSpec(dggm="residual"),
        "map_7channel_g",
    ),
    "0.0.5": _e(
        ChannelSpec(total=7, gradient=(3, 6), gradient_mask=(6, 7)),
        FusionSpec(dggm="residual"),
        "map_7channel_g2",
    ),
    "0.0.6": _e(
        ChannelSpec(total=7, gradient=(3, 6), gradient_mask=(6, 7)),
        FusionSpec(dggm="residual"),
        "map_7channel_s",
    ),
    # RGB + gray depth; surface normals + intrinsics predictor in-forward.
    "0.0.7": _e(
        ChannelSpec(total=4, gray_depth=(3, 4)),
        FusionSpec(dggm="residual", dggm_source="normals", intrinsics_normals=True),
        "map_7channel_s2",
    ),
    # RGB + depth; dual backbone + FeatureFuser.
    "0.1.0": _e(
        ChannelSpec(total=6, depth=(3, 6)),
        FusionSpec(dual_backbone=True, feature_fuser=True),
        "map_6channel",
    ),
    # + DSAM cascade.
    "0.1.1": _e(
        ChannelSpec(total=6, depth=(3, 6)),
        FusionSpec(dual_backbone=True, feature_fuser=True, dsam=True),
        "map_6channel",
    ),
    # single backbone + DSAM cascade.
    "0.1.2": _e(
        ChannelSpec(total=6, depth=(3, 6)),
        FusionSpec(dsam=True),
        "map_6channel",
    ),
    # + depth backbone driving a RatioPredictor.
    "0.1.3": _e(
        ChannelSpec(total=6, depth=(3, 6)),
        FusionSpec(dual_backbone=True, dsam=True, ratio="backbone"),
        "map_6channel",
    ),
    # 30ch multi-modality with CSF fusion (default branch in reference forward).
    "0.2.0": _e(
        ChannelSpec(total=9, depth=(3, 6), fused_depth=(6, 9)),
        FusionSpec(dual_backbone=True, feature_fuser=True, dsam=True, dsam_source="fused_depth"),
        "map_30channel",
    ),
    # RGB + depth + gradient + mask; backbone ratio + DSAM + DGGM residual.
    "0.3.0": _e(
        ChannelSpec(total=10, depth=(3, 6), gradient=(6, 9), gradient_mask=(9, 10)),
        FusionSpec(dual_backbone=True, dsam=True, ratio="backbone", dggm="residual"),
        "map_10channel_case1",
    ),
    # Final paper model: E-DSAM predictor + DSAM + DGGM residual, two-branch sum.
    "0.4.0": _e(
        ChannelSpec(total=10, depth=(3, 6), gradient=(6, 9), gradient_mask=(9, 10)),
        FusionSpec(dsam=True, ratio="enhanced", dggm="residual", two_branch_sum=True),
        "map_10channel_case2",
    ),
}


def get(version: str) -> VersionEntry:
    if version not in REGISTRY:
        raise KeyError(f"unknown version {version!r}; known: {sorted(REGISTRY)}")
    return REGISTRY[version]


def _validate() -> None:
    for v, entry in REGISTRY.items():
        c = entry.channels
        groups = [c.rgb, c.depth, c.gradient, c.gradient_mask, c.gray_depth, c.fused_depth, c.modalities]
        hi = max(g[1] for g in groups if g is not None)
        if hi != c.total:
            raise ValueError(f"version {v}: channel groups end at {hi} but total={c.total}")
        f = entry.fusion
        if f.dsam and f.dsam_source == "depth" and c.depth is None:
            raise ValueError(f"version {v}: DSAM needs depth channels")
        if f.dggm == "residual" and f.dggm_source == "gradient" and c.gradient is None:
            raise ValueError(f"version {v}: DGGM-residual needs gradient channels")
        if f.ratio == "enhanced" and c.depth is None:
            raise ValueError(f"version {v}: E-DSAM ratio predictor needs depth channels")


_validate()
