"""Bag player / frame curator (reference: intelRealSense/display.py:301-449;
counterpart of `rgbdseg_tpu/tools/realsense/display.py`, without cv2).

Replays a RealSense .bag, producing per frame the 12 modalities the reference
curates: color, 2 depth colormaps, 3 RealSense filters (decimation, spatial,
hole-filling), and 6 enhancement ops (see depth_enhance). The colormaps and
enhancements run in torch on the card unless `device` names another
(`parallel/mesh.py::mesh_device`); the frames are saved as PNG + NPY per
modality into structured directories, the PNGs with cv2's pixels
(`data/image_io.write_png`: 16-bit depth, colour and colormaps in cv2's BGR
order). Interactive curation reads a/d/s/q lines from standard input (a
machine without cv2 has no window to read keys from) and writes the frame
on show to `<save_dir>/_preview.png`. pyrealsense2 is needed only for the
playback itself and is imported there.

    python -m rgbdseg_torch.tools.realsense.display --bag rec.bag --save_dir frames [--no-interactive] \
        [--device cpu]
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

from ...data.image_io import write_png
from ...parallel.mesh import mesh_device
from .depth_enhance import COLORMAP_BONE, COLORMAP_JET, apply_colormap, convert_scale_abs, enhance_all, u16_to_device


def _rs():
    try:
        import pyrealsense2 as rs

        return rs
    except ImportError as e:  # pragma: no cover
        raise ImportError("pyrealsense2 is required for bag playback.") from e


def do_depth_image_filter(rs, depth_frame) -> dict:
    """RealSense post-processing filters (reference :123-189)."""
    out = {}
    dec = rs.decimation_filter()
    dec.set_option(rs.option.filter_magnitude, 2)
    out["decimation"] = np.asanyarray(dec.process(depth_frame).get_data())
    spat = rs.spatial_filter()
    out["spatial"] = np.asanyarray(spat.process(depth_frame).get_data())
    hole = rs.hole_filling_filter()
    out["hole_filling"] = np.asanyarray(hole.process(depth_frame).get_data())
    return out


def do_depth_image_process(depth_u16, device=None) -> dict[str, torch.Tensor]:
    """Colormaps + enhancement modalities from the raw z16 depth (:104-120), as
    uint8 tensors on the device (colormaps (H, W, 3) in BGR order)."""
    gray = convert_scale_abs(u16_to_device(depth_u16, mesh_device(device)), alpha=0.03)
    out = {
        "colormap_jet": apply_colormap(gray, COLORMAP_JET),
        "colormap_bone": apply_colormap(gray, COLORMAP_BONE),
    }
    out.update(enhance_all(gray))
    return out


def _host(arr) -> np.ndarray:
    return arr.cpu().numpy() if torch.is_tensor(arr) else np.asarray(arr)


def save_frame(save_dir: str, index: int, modalities: dict) -> None:
    """Each modality as `<save_dir>/<name>/<index>.png` (the pixels cv2.imwrite
    writes) and `.npy`."""
    for name, arr in modalities.items():
        arr = _host(arr)
        d = os.path.join(save_dir, name)
        os.makedirs(d, exist_ok=True)
        write_png(os.path.join(d, f"{index}.png"), arr, bgr=True)
        np.save(os.path.join(d, f"{index}.npy"), arr)


def checkout(bag_path: str, save_dir: str, interactive: bool = True, device=None, keys=None) -> int:
    """Replay a bag; curate frames (a=prev, d=next, s=save, q=quit, one per
    line of `keys`, standard input by default). Returns number of saved
    frames. With interactive=False saves every frame."""
    rs = _rs()

    pipeline = rs.pipeline()
    config = rs.config()
    config.enable_device_from_file(bag_path, repeat_playback=False)
    pipeline.start(config)

    frames_cache = []
    try:
        while True:
            try:
                frames = pipeline.wait_for_frames(timeout_ms=1000)
            except RuntimeError:
                break
            depth = frames.get_depth_frame()
            color = frames.get_color_frame()
            if not depth or not color:
                continue
            modalities = {"color": np.asanyarray(color.get_data())}
            d16 = np.asanyarray(depth.get_data())
            modalities["depth_raw"] = d16
            modalities.update(do_depth_image_process(d16, device))
            modalities.update({k: v for k, v in do_depth_image_filter(rs, depth).items()})
            frames_cache.append(modalities)
    finally:
        pipeline.stop()

    saved = 0
    if not interactive:
        for i, m in enumerate(frames_cache):
            save_frame(save_dir, i, m)
            saved += 1
        return saved

    keys = sys.stdin if keys is None else keys
    idx = 0
    os.makedirs(save_dir, exist_ok=True)
    while frames_cache:
        m = frames_cache[idx]
        write_png(os.path.join(save_dir, "_preview.png"), _host(m["color"]), bgr=True)
        key = keys.readline().strip()[:1]
        if key in ("q", ""):  # "" : the input has ended
            break
        if key == "a":
            idx = max(0, idx - 1)
        elif key == "d":
            idx = min(len(frames_cache) - 1, idx + 1)
        elif key == "s":
            save_frame(save_dir, idx, m)
            saved += 1
    return saved


if __name__ == "__main__":  # pragma: no cover
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--bag", required=True)
    ap.add_argument("--save_dir", required=True)
    ap.add_argument("--no-interactive", action="store_true")
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    a = ap.parse_args()
    n = checkout(a.bag, a.save_dir, interactive=not a.no_interactive, device=a.device)
    print(f"saved {n} frames")
