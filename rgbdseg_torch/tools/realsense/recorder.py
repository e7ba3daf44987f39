"""Rotating .bag recorder for Intel RealSense (reference: intelRealSense/
recorder.py:21-108; counterpart of `rgbdseg_tpu/tools/realsense/recorder.py`,
without cv2): depth z16 + color bgr8 @ 1280x720x30fps, file rotation every
`interval` seconds, optional preview.

The preview writes the colour frame beside the depth's JET colormap to
`<save_dir>/_preview.png` (a machine without cv2 has no window), the
colormap computed in torch on the card unless `device` names another.
pyrealsense2 is imported at call time, so the rest of the port imports
without it.

    python -m rgbdseg_torch.tools.realsense.recorder --save_dir bags [--interval 60] [--preview] [--device cpu]
"""

from __future__ import annotations

import os
import time


def _rs():
    try:
        import pyrealsense2 as rs

        return rs
    except ImportError as e:  # pragma: no cover
        raise ImportError(
            "pyrealsense2 is required for sensor capture; install librealsense."
        ) from e


def recorder(save_dir: str, interval: float = 60.0, preview: bool = False, device=None) -> None:
    """Record rotating .bag files until interrupted."""
    rs = _rs()
    os.makedirs(save_dir, exist_ok=True)
    file_index = 0
    try:
        while True:
            pipeline = rs.pipeline()
            config = rs.config()
            config.enable_stream(rs.stream.depth, 1280, 720, rs.format.z16, 30)
            config.enable_stream(rs.stream.color, 1280, 720, rs.format.bgr8, 30)
            bag_path = os.path.join(save_dir, f"record_{file_index:04d}.bag")
            config.enable_record_to_file(bag_path)
            pipeline.start(config)
            t0 = time.time()
            try:
                while time.time() - t0 < interval:
                    frames = pipeline.wait_for_frames()
                    if preview:
                        _preview(frames, save_dir, device)
            finally:
                pipeline.stop()
            file_index += 1
    except KeyboardInterrupt:
        pass


def _preview(frames, save_dir: str, device=None) -> None:
    import numpy as np

    from ...data.image_io import write_png
    from ...parallel.mesh import mesh_device
    from .depth_enhance import COLORMAP_JET, apply_colormap, convert_scale_abs, u16_to_device

    depth = frames.get_depth_frame()
    color = frames.get_color_frame()
    if not depth or not color:
        return
    d = u16_to_device(np.asanyarray(depth.get_data()), mesh_device(device))
    c = np.asanyarray(color.get_data())
    dc = apply_colormap(convert_scale_abs(d, alpha=0.03), COLORMAP_JET).cpu().numpy()
    write_png(os.path.join(save_dir, "_preview.png"), np.hstack([c, dc]), bgr=True)


if __name__ == "__main__":  # pragma: no cover
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--save_dir", required=True)
    ap.add_argument("--interval", type=float, default=60.0)
    ap.add_argument("--preview", action="store_true")
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    a = ap.parse_args()
    recorder(a.save_dir, a.interval, a.preview, a.device)
