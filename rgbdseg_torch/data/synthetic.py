"""Synthetic RGB-D fixture dataset generator (a copy of
`rgbdseg_tpu/data/synthetic.py` without cv2).

Writes a tiny on-disk dataset in the reference's meta-JSON format: RGB images
with coloured shapes, aligned depth (shapes at distinct depths), 3-channel
instance and semantic masks, train/valid meta JSON and label2id.json. The
draws from `np.random.RandomState(seed)` come in the JAX generator's order, so
the same seed gives the same scenes. The shapes are drawn as cv2 draws them:
- a filled rectangle covers the inclusive box, clipped to the image;
- a filled circle is OpenCV's integer midpoint routine (`Circle` in
  drawing.cpp, which `cv2.circle(..., thickness=-1)` takes for LINE_8 and
  shift 0): horizontal spans, clipped to the image;
- the texture is a saturating uint8 add (`cv2.add`);
- a modality image is `cv2.convertScaleAbs`: |d * alpha + beta| in float32,
  rounded half to even and saturated to uint8.
The files come from `image_io.write_png`. The JAX generator writes through
`cv2.imwrite`, whose files hold the same decoded arrays (its 3-channel mask
array is taken as BGR, so the file's RGB is the array reversed, which
`image_io.load_unchanged` reverses back).
"""

from __future__ import annotations

import json
import os

import numpy as np

from .image_io import write_png


def fill_rectangle(canvas: np.ndarray, p0, p1, value) -> None:
    """cv2.rectangle(canvas, p0, p1, value, -1): the inclusive box between the
    two (x, y) corners, clipped to the canvas."""
    h, w = canvas.shape[:2]
    x0, x1 = sorted((int(p0[0]), int(p1[0])))
    y0, y1 = sorted((int(p0[1]), int(p1[1])))
    x0, y0, x1, y1 = max(x0, 0), max(y0, 0), min(x1, w - 1), min(y1, h - 1)
    if x0 <= x1 and y0 <= y1:
        canvas[y0 : y1 + 1, x0 : x1 + 1] = value


def fill_circle(canvas: np.ndarray, center, radius: int, value) -> None:
    """cv2.circle(canvas, center, radius, value, -1) with LINE_8 and shift 0:
    OpenCV's midpoint loop over (dx, dy) from (radius, 0) while dx >= dy, which
    fills rows cy -+ dy over [cx - dx, cx + dx] and rows cy -+ dx over
    [cx - dy, cx + dy], each span clipped to the canvas."""
    h, w = canvas.shape[:2]
    cx, cy, r = int(center[0]), int(center[1]), int(radius)
    if r < 0:
        raise ValueError(f"radius {r} < 0")

    def span(y: int, xl: int, xr: int) -> None:
        if 0 <= y < h:
            xl, xr = max(xl, 0), min(xr, w - 1)
            if xl <= xr:
                canvas[y, xl : xr + 1] = value

    err, dx, dy, plus, minus = 0, r, 0, 1, 2 * r - 1
    while dx >= dy:
        if cx - dx < w and cx + dx >= 0 and cy - dx < h and cy + dx >= 0:
            span(cy - dy, cx - dx, cx + dx)
            span(cy + dy, cx - dx, cx + dx)
            if cx - dy < w and cx + dy >= 0:
                span(cy - dx, cx - dy, cx + dy)
                span(cy + dx, cx - dy, cx + dy)
        dy += 1
        err += plus
        plus += 2
        if err > 0:
            err -= minus
            dx -= 1
            minus -= 2


def add_saturate(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """cv2.add of two uint8 arrays: the sum clipped to 255."""
    return np.minimum(a.astype(np.int16) + b.astype(np.int16), 255).astype(np.uint8)


def convert_scale_abs(src: np.ndarray, alpha: float = 1.0, beta: float = 0.0) -> np.ndarray:
    """cv2.convertScaleAbs of a uint8 array: |src * alpha + beta| in float32,
    rounded half to even, saturated to uint8."""
    x = np.abs(src.astype(np.float32) * np.float32(alpha) + np.float32(beta))
    return np.clip(np.rint(x), 0, 255).astype(np.uint8)


def _draw_scene(rng: np.random.RandomState, h: int, w: int, num_objects: int):
    rgb = np.full((h, w, 3), 30, np.uint8)
    rgb[:] = rng.randint(20, 60, size=(1, 1, 3), dtype=np.uint8)
    depth = np.full((h, w), 200, np.uint8)  # background far
    mask = np.zeros((h, w, 3), np.uint8)  # ch1 = instance id, ch2 = semantic id

    for i in range(num_objects):
        inst_id = i + 1
        sem_id = rng.randint(1, 3)  # classes 1..2 (0 = background)
        color = rng.randint(80, 255, size=3).tolist()
        # clamp below the 200 background so dense scenes (10+ objects) stay
        # valid uint8 and every object remains nearer than the background
        obj_depth = int(min(40 + 40 * i + rng.randint(0, 10), 195))
        cx, cy = rng.randint(w // 6, 5 * w // 6), rng.randint(h // 6, 5 * h // 6)
        r = rng.randint(min(h, w) // 10, min(h, w) // 5)
        shape = rng.randint(0, 2)
        canvas = np.zeros((h, w), np.uint8)
        if shape == 0:
            fill_circle(canvas, (cx, cy), r, 1)
        else:
            fill_rectangle(canvas, (cx - r, cy - r), (cx + r, cy + r), 1)
        sel = canvas.astype(bool)
        rgb[sel] = color
        depth[sel] = obj_depth
        mask[sel, 1] = inst_id
        mask[sel, 2] = sem_id

    # mild texture so gradients are non-trivial
    noise = rng.randint(0, 12, size=(h, w, 3), dtype=np.uint8)
    rgb = add_saturate(rgb, noise)
    return rgb, depth, mask


def generate(
    root: str,
    num_train: int = 6,
    num_valid: int = 3,
    size: tuple[int, int] = (96, 128),
    seed: int = 0,
    num_modalities: int = 0,
    num_objects: tuple[int, int] = (1, 4),
) -> dict:
    """Write the fixture dataset; returns paths dict.

    num_modalities > 0 additionally writes that many augmentation-modality
    images per example (for the 30-channel/CSF path). num_objects is the
    [lo, hi) range of instances per image (NYUv2-like density needs ~10+).
    """
    h, w = size
    rng = np.random.RandomState(seed)
    os.makedirs(root, exist_ok=True)
    for sub in ("images", "depth", "mask"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)

    def make_split(name, n, offset):
        records = []
        for i in range(n):
            idx = offset + i
            rgb, depth, mask = _draw_scene(rng, h, w, num_objects=rng.randint(*num_objects))
            ip = f"images/{idx}.png"
            dp = f"depth/{idx}.png"
            mp = f"mask/{idx}.png"
            write_png(os.path.join(root, ip), rgb)
            write_png(os.path.join(root, dp), depth)
            write_png(os.path.join(root, mp), np.ascontiguousarray(mask[..., ::-1]))  # stored as cv2 stores BGR
            images = [ip, dp]
            for m in range(num_modalities):
                mod = convert_scale_abs(depth, alpha=1.0 + 0.1 * m, beta=5 * m)
                mpth = f"depth/{idx}_mod{m}.png"
                write_png(os.path.join(root, mpth), mod)
                images.append(mpth)
            records.append(
                {
                    "image": images,
                    "annotation": mp,
                    "semantic_class_to_id": {"background": 0, "box": 1, "ball": 2},
                }
            )
        meta_path = os.path.join(root, f"{name}.json")
        with open(meta_path, "w") as f:
            json.dump(records, f)
        return meta_path

    train = make_split("train", num_train, 0)
    valid = make_split("valid", num_valid, num_train)
    label2id = {"background": 0, "box": 1, "ball": 2}
    with open(os.path.join(root, "label2id.json"), "w") as f:
        json.dump(label2id, f)
    return {"root": root, "train": train, "valid": valid, "label2id": os.path.join(root, "label2id.json")}
