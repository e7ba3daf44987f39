"""Dataset construction: CVAT/COCO annotations -> 3-channel masks + meta JSON
(counterpart of `rgbdseg_tpu/tools/dataset_builder.py`, without cv2).

Capability parity with the reference's dataset_constructor pipeline
(reference: data_process.py:100-121 combine_sematic_instance_mask,
:512-572 generate_combined_masks, :370-397 split2train_and_valid,
:400-487 generate_meta_file, :575-625 dataset_constructor).

Mask format (reference: data_process.py:111-117): 3-channel PNG where, as read
by cv2 (BGR), channel 1 carries instance ids and channel 2 semantic ids;
channel 0 is unused. The masks are uint16 and written as 16-bit PNGs in cv2's
channel order (`data/image_io.write_png(..., bgr=True)`), the files
``cv2.imwrite`` writes.

`fill_poly` is ``cv2.fillPoly(img, polys, 1)`` (line type 8, shift 0) in
numpy, pixel for pixel. OpenCV (imgproc/src/drawing.cpp, CollectPolyEdges
and FillEdgeCollection) is not a plain even-odd scanline fill:
- every edge is also drawn as its 8-connected line (Bresenham, after
  `clipLine` to the image), so the fill covers its outline;
- each edge that crosses rows steps its x in 16.16 fixed point, from its upper
  vertex, by the slope truncated toward zero;
- an edge with an end outside the image is stepped from its clipped ends (the
  clipped rows, or its own rows where clipping leaves it flat);
- each row fills the pixels whose centres lie between consecutive crossings,
  taken in order of x, and no row at or below an edge's lower vertex counts
  that edge.
"""

from __future__ import annotations

import json
import os
from collections import defaultdict

import numpy as np

from ..data.image_io import write_png
from ..inference import rle as rle_codec

XY_SHIFT = 16


def combine_semantic_instance_mask(semantic: np.ndarray, instance: np.ndarray) -> np.ndarray:
    """Two grayscale masks -> 3-channel combined mask (ch1=instance, ch2=semantic)."""
    h, w = semantic.shape[:2]
    out = np.zeros((h, w, 3), np.uint8 if semantic.max() < 256 and instance.max() < 256 else np.uint16)
    out[..., 1] = instance
    out[..., 2] = semantic
    return out


def _clip_lines(h: int, w: int, x1, y1, x2, y2):
    """OpenCV's clipLine of each segment to the (h, w) image, int64 arrays:
    (inside, x1, y1, x2, y2), the ends moved onto the border as far as the
    algorithm gets, also for a segment it then reports as outside."""
    x1, y1, x2, y2 = (np.array(v, np.int64) for v in (x1, y1, x2, y2))
    right, bottom = w - 1, h - 1

    def code(x, y):
        return (x < 0) + (x > right) * 2 + (y < 0) * 4 + (y > bottom) * 8

    def moved(num, d_other, den):  # (double)(num) * d_other / den, truncated toward zero
        with np.errstate(divide="ignore", invalid="ignore"):
            v = num.astype(np.float64) * d_other.astype(np.float64) / den.astype(np.float64)
        return np.trunc(np.where(np.isfinite(v), v, 0.0)).astype(np.int64)

    c1, c2 = code(x1, y1), code(x2, y2)
    act = ((c1 & c2) == 0) & ((c1 | c2) != 0)
    sel = act & ((c1 & 12) != 0)
    a = np.where(c1 < 8, 0, bottom)
    x1 = np.where(sel, x1 + moved(a - y1, x2 - x1, y2 - y1), x1)
    y1 = np.where(sel, a, y1)
    c1 = np.where(sel, (x1 < 0) + (x1 > right) * 2, c1)
    sel = act & ((c2 & 12) != 0)
    a = np.where(c2 < 8, 0, bottom)
    x2 = np.where(sel, x2 + moved(a - y2, x2 - x1, y2 - y1), x2)
    y2 = np.where(sel, a, y2)
    c2 = np.where(sel, (x2 < 0) + (x2 > right) * 2, c2)
    act &= ((c1 & c2) == 0) & ((c1 | c2) != 0)
    sel = act & (c1 != 0)
    a = np.where(c1 == 1, 0, right)
    y1 = np.where(sel, y1 + moved(a - x1, y2 - y1, x2 - x1), y1)
    x1 = np.where(sel, a, x1)
    c1 = np.where(sel, 0, c1)
    sel = act & (c2 != 0)
    a = np.where(c2 == 1, 0, right)
    y2 = np.where(sel, y2 + moved(a - x2, y2 - y1, x2 - x1), y2)
    x2 = np.where(sel, a, x2)
    c2 = np.where(sel, 0, c2)
    return (c1 | c2) == 0, x1, y1, x2, y2


def _draw_lines(img: np.ndarray, inside, x1, y1, x2, y2) -> None:
    """OpenCV's 8-connected lines (LineIterator, left to right) of value 1,
    of the segments `_clip_lines` clipped (those it found `inside`)."""
    x1, y1, x2, y2 = x1[inside], y1[inside], x2[inside], y2[inside]
    swap = x2 < x1
    x1, x2 = np.where(swap, x2, x1), np.where(swap, x1, x2)
    y1, y2 = np.where(swap, y2, y1), np.where(swap, y1, y2)
    dx, dy = x2 - x1, np.abs(y2 - y1)
    sy = np.where(y2 < y1, -1, 1)
    vert = dy > dx
    major, minor = np.maximum(dx, dy), np.minimum(dx, dy)
    # point k: the major coordinate steps every time, the minor one when the
    # Bresenham error (from dx - 2 dy) has gone negative: k-th minor offset
    # (2 * minor * k + major - 1) // (2 * major)
    k = np.arange(int((major + 1).sum())) - np.repeat(np.cumsum(major + 1) - (major + 1), major + 1)
    major_r, minor_r = np.repeat(major, major + 1), np.repeat(minor, major + 1)
    m = np.where(major_r > 0, (2 * minor_r * k + major_r - 1) // np.maximum(2 * major_r, 1), 0)
    vert_r, sy_r = np.repeat(vert, major + 1), np.repeat(sy, major + 1)
    xs = np.repeat(x1, major + 1) + np.where(vert_r, m, k)
    ys = np.repeat(y1, major + 1) + sy_r * np.where(vert_r, k, m)
    img[ys, xs] = 1


def fill_poly(img: np.ndarray, polys) -> None:
    """``cv2.fillPoly(img, polys, 1)`` on an (H, W) uint8 image, in place:
    `polys` is a list of (n, 2) integer (x, y) vertex arrays, filled together
    (even-odd over all rings)."""
    h, w = img.shape
    edges = []  # (y0, y1, x at y0 in 16.16, dx per row)
    for v in polys:
        v = np.asarray(v, np.int64).reshape(-1, 2)
        if not len(v):
            continue
        p0, p1 = np.roll(v, 1, axis=0), v  # edge i: vertex i-1 -> vertex i
        x0, y0, x1, y1 = p0[:, 0], p0[:, 1], p1[:, 0], p1[:, 1]
        inside, cx0, cy0, cx1, cy1 = _clip_lines(h, w, x0, y0, x1, y1)
        _draw_lines(img, inside, cx0, cy0, cx1, cy1)
        outside = (x0 < 0) | (x0 >= w) | (x1 < 0) | (x1 >= w) | (y0 < 0) | (y0 >= h) | (y1 < 0) | (y1 >= h)
        flat = cy0 == cy1
        sx0 = np.where(outside, cx0, x0) << XY_SHIFT
        sx1 = np.where(outside, cx1, x1) << XY_SHIFT
        sy0 = np.where(outside & ~flat, cy0, y0)
        sy1 = np.where(outside & ~flat, cy1, y1)
        keep = y0 != y1
        num, den = (sx1 - sx0)[keep], (sy1 - sy0)[keep]
        dx = np.sign(num) * np.sign(den) * (np.abs(num) // np.abs(den))
        down = (y0 < y1)[keep]
        top = np.where(down, y0[keep], y1[keep])
        x_top = np.where(down, sx0[keep] + (y0[keep] - sy0[keep]) * dx, sx1[keep] + (y1[keep] - sy1[keep]) * dx)
        edges.append(np.stack([top, np.where(down, y1[keep], y0[keep]), x_top, dx], 1))
    edges = np.concatenate(edges) if edges else np.zeros((0, 4), np.int64)
    if len(edges) < 2:
        return
    ey0, ey1, ex, edx = edges.T
    x_end = ex + (ey1 - ey0) * edx
    if ey1.max() < 0 or ey0.min() >= h or max(ex.max(), x_end.max()) < 0 or \
            min(ex.min(), x_end.min()) >= (w << XY_SHIFT):
        return
    # every edge's crossing of each row it spans inside the image
    first, last = np.maximum(ey0, 0), np.minimum(ey1, h)
    n = np.maximum(last - first, 0)
    rows = np.repeat(first, n) + np.arange(int(n.sum())) - np.repeat(np.cumsum(n) - n, n)
    xs = np.repeat(ex, n) + (rows - np.repeat(ey0, n)) * np.repeat(edx, n)
    order = np.lexsort((xs, rows))
    rows, xs = rows[order].reshape(-1, 2), xs[order].reshape(-1, 2)  # each row holds an even count
    r, lo, hi = rows[:, 0], (xs[:, 0] + (1 << XY_SHIFT) - 1) >> XY_SHIFT, xs[:, 1] >> XY_SHIFT
    sel = (lo < w) & (hi >= 0)
    r, lo, hi = r[sel], np.maximum(lo[sel], 0), np.minimum(hi[sel], w - 1)
    sel = lo <= hi
    runs = np.zeros((h, w + 1), np.int32)
    np.add.at(runs, (r[sel], lo[sel]), 1)
    np.add.at(runs, (r[sel], hi[sel] + 1), -1)
    img[np.cumsum(runs[:, :w], axis=1) > 0] = 1


def polygon_to_mask(polygon, h: int, w: int) -> np.ndarray:
    """COCO polygon(s) -> binary mask (cv2.fillPoly rasterization)."""
    mask = np.zeros((h, w), np.uint8)
    polys = polygon if isinstance(polygon[0], (list, np.ndarray)) else [polygon]
    pts = [np.asarray(p, np.float64).reshape(-1, 2).round().astype(np.int32) for p in polys]
    fill_poly(mask, pts)
    return mask


def rasterize_coco(coco_json: str, images_dir: str, masks_dir: str) -> list[dict]:
    """COCO instance annotations -> combined 3-channel masks on disk.

    Returns records [{"image", "annotation", "semantic_class_to_id"}].
    """
    with open(coco_json) as f:
        coco = json.load(f)
    os.makedirs(masks_dir, exist_ok=True)
    cats = {c["id"]: c["name"] for c in coco["categories"]}
    label2id = {"background": 0}
    for cid in sorted(cats):
        label2id[cats[cid]] = len(label2id)

    anns_by_img = defaultdict(list)
    for a in coco["annotations"]:
        anns_by_img[a["image_id"]].append(a)

    records = []
    for img in coco["images"]:
        h, w = img["height"], img["width"]
        combined = np.zeros((h, w, 3), np.uint16)
        inst_counter = 0
        for a in anns_by_img.get(img["id"], []):
            inst_counter += 1
            seg = a["segmentation"]
            if isinstance(seg, dict):
                m = rle_codec.decode(seg).astype(bool)
            else:
                m = polygon_to_mask(seg, h, w).astype(bool)
            combined[m, 1] = inst_counter
            combined[m, 2] = label2id[cats[a["category_id"]]]
        mask_path = os.path.join(masks_dir, os.path.splitext(img["file_name"])[0] + ".png")
        os.makedirs(os.path.dirname(mask_path), exist_ok=True)
        write_png(mask_path, combined, bgr=True)
        records.append(
            {
                "image": os.path.join(images_dir, img["file_name"]),
                "annotation": mask_path,
                "semantic_class_to_id": label2id,
            }
        )
    return records


def split_train_valid(records: list, train_ratio: float = 0.7, seed: int = 0) -> tuple[list, list]:
    """70/30 split (reference: data_process.py:370-397)."""
    rng = np.random.RandomState(seed)
    order = rng.permutation(len(records))
    n_train = int(len(records) * train_ratio)
    train = [records[i] for i in order[:n_train]]
    valid = [records[i] for i in order[n_train:]]
    return train, valid


def write_meta(records: list, path: str) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(records, f, indent=2)


def dataset_constructor(
    coco_json: str,
    images_dir: str,
    output_dir: str,
    train_ratio: float = 0.7,
    seed: int = 0,
) -> dict:
    """End-to-end build: rasterize -> split -> meta files + label2id.json."""
    records = rasterize_coco(coco_json, images_dir, os.path.join(output_dir, "mask"))
    train, valid = split_train_valid(records, train_ratio, seed)
    write_meta(train, os.path.join(output_dir, "train.json"))
    write_meta(valid, os.path.join(output_dir, "valid.json"))
    label2id = records[0]["semantic_class_to_id"] if records else {"background": 0}
    with open(os.path.join(output_dir, "label2id.json"), "w") as f:
        json.dump(label2id, f, indent=2)
    return {
        "train": os.path.join(output_dir, "train.json"),
        "valid": os.path.join(output_dir, "valid.json"),
        "label2id": os.path.join(output_dir, "label2id.json"),
    }
