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

Ported layouts: `map_3channel` (0.0.0) and `map_10channel_case2` (0.4.0). The
others raise NotImplementedError: they come with their versions (ROADMAP.md,
"Modules to port", item 4).

Reference provenance: dataloader.py:23-49 (3ch) and :386-425 (10ch case2).
"""

from __future__ import annotations

import torch

from ..config import PreprocessConfig
from ..ops.resize_exact import cv2_resize_linear_u8, pil_resize_u8
from ..ops.sobel import gradient_features
from .preprocess import output_size

# uint8 frame channels each ported map function needs (rgb first).
_PACKED_WIDTH = {
    "map_3channel": 3,  # rgb
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
            f"the port builds the channels of {sorted(_PACKED_WIDTH)}, not {map_fn_name!r}; "
            "the other layouts come with their versions (ROADMAP.md, 'Modules to port', item 4)"
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
    map_fn_name: str, rgb_u8: torch.Tensor, depth_u8: torch.Tensor | None, cfg: PreprocessConfig
) -> torch.Tensor:
    """Raw (B, H, W, 3) uint8 frames -> the version's float32 channel stack
    (B, H', W', C) at `output_size(cfg)`, on the frames' device. `depth_u8` is the
    depth frame as an RGB image (a gray depth PNG converted to RGB)."""
    _check_supported(map_fn_name)
    size = output_size(cfg)

    def pil(x):
        return x if tuple(x.shape[-3:-1]) == size else pil_resize_u8(x, size, has_channels=True)

    color = normalize_u8(pil(rgb_u8), cfg)
    if map_fn_name == "map_3channel":
        return color
    if depth_u8 is None:
        raise ValueError(f"{map_fn_name} needs a depth frame")
    depth = normalize_u8(pil(depth_u8), cfg)
    gray = pil_grayscale_u8(depth_u8)  # at the source size, as the host builder
    if tuple(gray.shape[-2:]) != size:
        gray = cv2_resize_linear_u8(gray, size, has_channels=False)
    norm_mag, _, _, valid = gradient_features(gray.to(torch.float32))
    return torch.cat([color, depth, norm_mag[..., None].expand(*norm_mag.shape, 3), valid[..., None]], dim=-1)


def unpack_masks(packed_u8: torch.Tensor, hw: tuple[int, int]) -> torch.Tensor:
    """Bit-packed masks (..., ceil(H*W/8)) uint8 in np.packbits order (MSB
    first) -> (..., H, W) float32 0/1, on the tensor's device."""
    h, w = hw
    shifts = torch.arange(7, -1, -1, dtype=torch.int32, device=packed_u8.device)
    bits = (packed_u8.to(torch.int32)[..., None] >> shifts) & 1
    flat = bits.reshape(*packed_u8.shape[:-1], -1)[..., : h * w]
    return flat.reshape(*packed_u8.shape[:-1], h, w).to(torch.float32)


def build_from_packed(map_fn_name: str, packed_u8: torch.Tensor, cfg: PreprocessConfig) -> torch.Tensor:
    """(B, H, W, packed_width) uint8 (rgb | depth) -> the float32 channel stack."""
    w = packed_width(map_fn_name)
    if packed_u8.shape[-1] != w:
        raise ValueError(f"{map_fn_name} takes {w} packed uint8 channels, got {tuple(packed_u8.shape)}")
    return build_pixels(map_fn_name, packed_u8[..., :3], packed_u8[..., 3:6] if w > 3 else None, cfg)
