"""Channel stacks built from raw uint8 frames, on the tensor's device
(counterpart of `rgbdseg_tpu/data/device_preprocess.py`).

This is the port's one channel builder: the same torch code runs on CPU
tensors (the host map functions of `data/registry.py`) and on CUDA tensors
(`Predictor.predict_example`, `train.trainer.evaluate`), so a caller ships raw
uint8 frames, 6 bytes per pixel for the 0.4.0 layout, instead of its 40-byte
float32 stack. It reproduces the JAX package's host builders:
- ImageNet normalisation as `data/preprocess.py::normalize_image` (float32, the
  mean and std as tensors, so the card divides as the CPU does);
- grayscale as PIL ``convert("L")``: (R*19595 + G*38470 + B*7471 + 0x8000) >> 16
  in int32 (the sum stays below 2^31);
- frames at another size than the target resized by the exact twins of
  `ops/resize_exact.py`, in the host builders' order: PIL BILINEAR for the
  normalised channels; grayscale at the source size, then cv2 INTER_LINEAR,
  then the Sobel gradient features (`ops/sobel.py`). Each frame is resized
  from its own size, so the frames of one example need not share one.

Layouts built here, as in the JAX package's device builder: `map_3channel`
(0.0.0), `map_6channel` (0.1.x), `map_7channel_tmp` (0.0.2, 0.0.3: the second
frame is the on-disk gradient image), `map_7channel_g2` (0.0.5: gradient
features), `map_7channel_s` (0.0.6: surface normals, `ops/normals.py`),
`map_7channel_s2` (0.0.7: the gray depth), `map_10channel_case1` (0.3.0: a
third frame, the on-disk gradient image) and `map_10channel_case2` (0.4.0).
`map_7channel_g` (0.0.4: the uint8 cast of a float64 Sobel magnitude) and
`map_30channel` (0.2.0: CSF over 8 frames) are built on the host only, as in
the JAX package; `supported()` says which, and callers choose the host map
function for the others before any launch.

Reference provenance: dataloader.py:23-49 (3ch), :53-84 (6ch), :132-168 (7ch
tmp), :214-238 (7ch g2), :242-266 (7ch s), :270-297 (4ch s2), :301-336 (10ch
case1), :386-425 (10ch case2).
"""

from __future__ import annotations

import torch

from ..config import PreprocessConfig
from ..ops.normals import surface_normals_gradient
from ..ops.resize_exact import cv2_resize_linear_u8, pil_resize_u8
from ..ops.sobel import gradient_features
from .preprocess import output_size

# uint8 frame channels each map function built here needs (rgb first).
_PACKED_WIDTH = {
    "map_3channel": 3,  # rgb
    "map_6channel": 6,  # rgb | depth
    "map_7channel_tmp": 6,  # rgb | gradient image (on disk)
    "map_7channel_g2": 6,  # rgb | depth (gray and gradient features built here)
    "map_7channel_s": 6,  # rgb | depth (gray and surface normals built here)
    "map_7channel_s2": 6,  # rgb | depth (gray built here)
    "map_10channel_case1": 9,  # rgb | depth | gradient image (on disk)
    "map_10channel_case2": 6,  # rgb | depth (gray and gradients built here)
}


def supported(map_fn_name: str) -> bool:
    return map_fn_name in _PACKED_WIDTH


def packed_width(map_fn_name: str) -> int:
    _check_supported(map_fn_name)
    return _PACKED_WIDTH[map_fn_name]


def _check_supported(map_fn_name: str) -> None:
    if map_fn_name not in _PACKED_WIDTH:
        raise NotImplementedError(
            f"the device builder builds the channels of {sorted(_PACKED_WIDTH)}, not {map_fn_name!r}: "
            "its stack is built on the host (data/registry.py)"
        )


def pil_grayscale_u8(rgb_u8: torch.Tensor) -> torch.Tensor:
    """PIL ``Image.convert("L")``: (..., 3) uint8 -> (...) uint8, integer-exact."""
    x = rgb_u8.to(torch.int32)
    return ((x[..., 0] * 19595 + x[..., 1] * 38470 + x[..., 2] * 7471 + 0x8000) >> 16).to(torch.uint8)


def normalize_u8(img_u8: torch.Tensor, cfg: PreprocessConfig) -> torch.Tensor:
    """`data/preprocess.py::normalize_image` of uint8 input."""
    x = img_u8.to(torch.float32)
    if cfg.do_rescale:
        x = x * torch.tensor(cfg.rescale_factor, dtype=torch.float32, device=x.device)
    if cfg.do_normalize:
        mean = torch.tensor(cfg.image_mean, dtype=torch.float32, device=x.device)
        std = torch.tensor(cfg.image_std, dtype=torch.float32, device=x.device)
        x = (x - mean) / std
    return x


def build_pixels(
    map_fn_name: str, rgb_u8: torch.Tensor, depth_u8: torch.Tensor | None, cfg: PreprocessConfig,
    grad_u8: torch.Tensor | None = None,
) -> torch.Tensor:
    """Raw (B, H, W, 3) uint8 frames -> the version's float32 channel stack
    (B, H', W', C) at `output_size(cfg)`, on the frames' device. `depth_u8` is
    the second frame as an RGB image (the depth, or for `map_7channel_tmp` the
    on-disk gradient image); `grad_u8` is `map_10channel_case1`'s third frame,
    its gradient image. Validity masks of gradient images are "> 50 on any
    channel" of the cv2-resized frame."""
    _check_supported(map_fn_name)
    size = output_size(cfg)

    def pil(x):
        return x if tuple(x.shape[-3:-1]) == size else pil_resize_u8(x, size, has_channels=True)

    def cv(x, has_channels=True):
        hw = tuple(x.shape[-3:-1] if has_channels else x.shape[-2:])
        return x if hw == size else cv2_resize_linear_u8(x, size, has_channels=has_channels)

    def over_50(x):
        return (cv(x) > 50).any(-1, keepdim=True).to(torch.float32)

    color = normalize_u8(pil(rgb_u8), cfg)
    if map_fn_name == "map_3channel":
        return color
    if depth_u8 is None:
        raise ValueError(f"{map_fn_name} needs a depth frame")
    if map_fn_name == "map_7channel_tmp":
        return torch.cat([color, normalize_u8(pil(depth_u8), cfg), over_50(depth_u8)], dim=-1)
    if map_fn_name in ("map_7channel_g2", "map_7channel_s", "map_7channel_s2", "map_10channel_case2"):
        # the host order: grayscale at the source size, then cv2's resize, then derive
        gray = cv(pil_grayscale_u8(depth_u8), has_channels=False).to(torch.float32)
        if map_fn_name == "map_7channel_s2":
            return torch.cat([color, gray[..., None]], dim=-1)
        if map_fn_name == "map_7channel_s":
            normals, valid = surface_normals_gradient(gray)
            return torch.cat([color, normals, valid[..., None]], dim=-1)
        norm_mag, _, _, valid = gradient_features(gray)
        grad = [norm_mag[..., None].expand(*norm_mag.shape, 3), valid[..., None]]
        if map_fn_name == "map_7channel_g2":
            return torch.cat([color, *grad], dim=-1)
        return torch.cat([color, normalize_u8(pil(depth_u8), cfg), *grad], dim=-1)
    depth = normalize_u8(pil(depth_u8), cfg)
    if map_fn_name == "map_6channel":
        return torch.cat([color, depth], dim=-1)
    # map_10channel_case1
    if grad_u8 is None:
        raise ValueError(f"{map_fn_name} needs its third frame, the gradient image")
    return torch.cat([color, depth, normalize_u8(pil(grad_u8), cfg), over_50(grad_u8)], dim=-1)


def unpack_masks(packed_u8: torch.Tensor, hw: tuple[int, int]) -> torch.Tensor:
    """Bit-packed masks (..., ceil(H*W/8)) uint8 in np.packbits order (MSB
    first) -> (..., H, W) float32 0/1, on the tensor's device."""
    h, w = hw
    shifts = torch.arange(7, -1, -1, dtype=torch.int32, device=packed_u8.device)
    bits = (packed_u8.to(torch.int32)[..., None] >> shifts) & 1
    flat = bits.reshape(*packed_u8.shape[:-1], -1)[..., : h * w]
    return flat.reshape(*packed_u8.shape[:-1], h, w).to(torch.float32)


def build_from_packed(map_fn_name: str, packed_u8: torch.Tensor, cfg: PreprocessConfig) -> torch.Tensor:
    """(B, H, W, packed_width) uint8 (rgb | frame 2 [| frame 3]) -> the float32 channel stack."""
    w = packed_width(map_fn_name)
    if packed_u8.shape[-1] != w:
        raise ValueError(f"{map_fn_name} takes {w} packed uint8 channels, got {tuple(packed_u8.shape)}")
    return build_pixels(map_fn_name, packed_u8[..., :3], packed_u8[..., 3:6] if w > 3 else None, cfg,
                        packed_u8[..., 6:9] if w > 6 else None)
