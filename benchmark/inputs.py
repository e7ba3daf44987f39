"""The benchmark's inputs, made from the seed: NYUv2-like raw frames and their
instance targets, as host numpy arrays.

A frame is a frozen copy of the rules of the port's synthetic generator
(`data/synthetic.py`: a dark background, filled circles and squares of random
colours, later shapes over earlier ones, a mild uint8 texture) with the depth of
`chip_smoke.py`'s frames (a tilted background plane, a tilted plane per shape,
rounded to 8 bits, 1% holes at 0). Each instance's mask is the pixels its id
keeps; an instance that later shapes cover whole is no instance. Every seed
gets the same multiset of instance counts (`counts`, cycled over the frames),
in an order drawn from the seed, so that a seed changes the pixels and not
the amount of work.
"""

from __future__ import annotations

import numpy as np


def frame(rng: np.random.Generator, h: int, w: int, n_objects: int):
    """(rgb (h, w, 3) uint8, depth (h, w) uint8, instance ids (h, w) uint8; 0 background)."""
    rgb = np.empty((h, w, 3), np.uint8)
    rgb[:] = rng.integers(20, 60, 3, dtype=np.uint8)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    depth = 200.0 - 0.05 * yy + np.float32(rng.uniform(-0.02, 0.02)) * xx
    inst = np.zeros((h, w), np.uint8)
    for i in range(n_objects):
        cx, cy = int(rng.integers(w // 6, 5 * w // 6)), int(rng.integers(h // 6, 5 * h // 6))
        r = int(rng.integers(min(h, w) // 10, min(h, w) // 5))
        y0, y1, x0, x1 = max(cy - r, 0), min(cy + r + 1, h), max(cx - r, 0), min(cx + r + 1, w)
        sel = np.ones((y1 - y0, x1 - x0), bool)
        if rng.integers(0, 2) == 0:  # a circle, else the square around it
            sel = (yy[y0:y1, x0:x1] - cy) ** 2 + (xx[y0:y1, x0:x1] - cx) ** 2 <= r * r
        plane = (np.float32(rng.uniform(40, 160)) + np.float32(rng.uniform(-0.1, 0.1)) * (yy[y0:y1, x0:x1] - cy)
                 + np.float32(rng.uniform(-0.1, 0.1)) * (xx[y0:y1, x0:x1] - cx))
        rgb[y0:y1, x0:x1][sel] = rng.integers(80, 255, 3, dtype=np.uint8)
        depth[y0:y1, x0:x1][sel] = plane[sel]
        inst[y0:y1, x0:x1][sel] = i + 1
    noise = rng.integers(0, 12, (h, w, 3), dtype=np.uint8)
    rgb = np.minimum(rgb.astype(np.int16) + noise, 255).astype(np.uint8)
    depth = np.clip(np.round(depth), 0, 255).astype(np.uint8)
    depth[rng.random((h, w)) < 0.01] = 0
    return rgb, depth, inst


def batches(seed: int, n_batches: int, batch: int, hw, slots: int, counts, num_labels: int, depth: bool):
    """`n_batches` host batches of distinct frames, each a dict of numpy arrays:
    `frames` (B, H, W, 6 | 3) uint8 (rgb | the depth as RGB, as its PNG reads),
    `masks` (B, slots, H, W) float32 0/1, `packed` (B, slots, ceil(H*W/8)) its
    np.packbits, `classes` (B, slots) int64 in [0, num_labels), `valid` (B, slots) bool."""
    h, w = hw
    rng = np.random.default_rng(seed)
    total = n_batches * batch
    per_frame = rng.permutation(np.resize(np.asarray(counts), total))
    out = []
    for b in range(n_batches):
        frames = np.empty((batch, h, w, 6 if depth else 3), np.uint8)
        masks = np.zeros((batch, slots, h, w), np.float32)
        for i in range(batch):
            n = int(per_frame[b * batch + i])
            rgb, d, inst = frame(rng, h, w, n)
            frames[i, ..., :3] = rgb
            if depth:
                frames[i, ..., 3:] = d[..., None]
            for k in range(min(n, slots)):
                masks[i, k] = inst == k + 1
        valid = masks.any(axis=(2, 3))
        out.append({
            "frames": frames,
            "masks": masks,
            "packed": np.packbits(masks.astype(bool).reshape(batch, slots, -1), axis=-1),
            "classes": rng.integers(0, num_labels, (batch, slots)).astype(np.int64),
            "valid": valid,
        })
    return out
