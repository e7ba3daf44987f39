"""LabelMe -> COCO instance-segmentation converter + multi-modality meta builder
(a copy of `rgbdseg_tpu/tools/labelme_coco.py`, which uses no cv2).

Capability parity with preprocess_archive_coco82_dataset.py (reference: :17-153
convert_labelme_to_coco_instance_segmentation with shoelace area + bbox,
:161-180 coco_category_id_constructor, :314-337 depth-expanded meta generation).
"""

from __future__ import annotations

import glob
import json
import os

import numpy as np


def shoelace_area(points: np.ndarray) -> float:
    x, y = points[:, 0], points[:, 1]
    return 0.5 * abs(float(np.dot(x, np.roll(y, 1)) - np.dot(y, np.roll(x, 1))))


def coco_category_id_constructor(labelme_files: list[str]) -> dict[str, int]:
    names = set()
    for f in labelme_files:
        with open(f) as fh:
            data = json.load(fh)
        for s in data.get("shapes", []):
            names.add(s["label"])
    return {name: i + 1 for i, name in enumerate(sorted(names))}


def convert_labelme_to_coco(labelme_dir: str, out_path: str) -> dict:
    files = sorted(glob.glob(os.path.join(labelme_dir, "*.json")))
    label2cat = coco_category_id_constructor(files)
    images, annotations = [], []
    ann_id = 0
    for img_id, f in enumerate(files):
        with open(f) as fh:
            data = json.load(fh)
        images.append(
            {
                "id": img_id,
                "file_name": data.get("imagePath", os.path.basename(f).replace(".json", ".png")),
                "height": data["imageHeight"],
                "width": data["imageWidth"],
            }
        )
        for shape in data.get("shapes", []):
            pts = np.asarray(shape["points"], np.float64)
            ann_id += 1
            annotations.append(
                {
                    "id": ann_id,
                    "image_id": img_id,
                    "category_id": label2cat[shape["label"]],
                    "segmentation": [pts.reshape(-1).tolist()],
                    "area": shoelace_area(pts),
                    "bbox": [
                        float(pts[:, 0].min()),
                        float(pts[:, 1].min()),
                        float(pts[:, 0].max() - pts[:, 0].min()),
                        float(pts[:, 1].max() - pts[:, 1].min()),
                    ],
                    "iscrowd": 0,
                }
            )
    coco = {
        "images": images,
        "annotations": annotations,
        "categories": [{"id": v, "name": k} for k, v in label2cat.items()],
    }
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(coco, f)
    return coco


def build_multimodal_meta(
    records: list[dict], modality_dirs: list[str], out_path: str
) -> list[dict]:
    """Expand meta records with per-modality image paths (the coco82v2 10-image
    layout, reference :314-337): image -> [rgb, depth, mod1, ...]."""
    out = []
    for rec in records:
        base = rec["image"] if isinstance(rec["image"], str) else rec["image"][0]
        stem = os.path.splitext(os.path.basename(base))[0]
        images = [base] + [os.path.join(d, stem + ".png") for d in modality_dirs]
        out.append({**rec, "image": images})
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(out, f, indent=2)
    return out
