"""Universal annotation converter: pluggable parsers -> 3-channel masks -> COCO
(counterpart of `rgbdseg_tpu/tools/annotation_converter.py`, without cv2).

Capability parity with the reference's AnnotationConverter
(reference: custom_mask_generator.py:143-887): pluggable input parsers
("coco", "separate_masks"), uint16 3-channel mask output with a global instance
counter, and the reverse path masks -> COCO JSON with polygon extraction by
border following (`native/contours.c`: cv2.findContours with RETR_CCOMP, whose
hierarchy marks holes, and cv2.contourArea).

The masks are written as 16-bit PNGs in cv2's channel order
(`data/image_io.write_png(..., bgr=True)`) and read back as
``cv2.IMREAD_UNCHANGED`` reads them (`image_io.load_unchanged`); the
separate-mask parser reads as ``cv2.IMREAD_GRAYSCALE`` does
(`image_io.load_gray_cv2`).

    python -m rgbdseg_torch.tools.annotation_converter --parser coco --source coco.json \
        --output_dir masks [--meta_out meta.json]
"""

from __future__ import annotations

import argparse
import glob
import json
import os
from typing import Callable, Iterator

import numpy as np

from .. import native
from ..data.image_io import load_gray_cv2, load_unchanged, write_png
from ..inference import rle as rle_codec
from .dataset_builder import polygon_to_mask


def mask_to_polygons(mask: np.ndarray, min_area: float = 1.0) -> tuple[list[list[float]], bool]:
    """Binary mask -> (COCO polygon list of outer contours, has_holes).

    The reference keeps hole hierarchy by appending child-contour points to
    the outer ring (custom_mask_generator.py:86-138) — which rasterizers fill
    inconsistently. We instead report `has_holes` so the caller can fall back
    to RLE for holed instances (exact round-trip); hole-free instances export
    compact polygons as before."""
    tracer = native.contours()
    contours, hierarchy = tracer.find(mask.astype(np.uint8))
    polys, has_holes = [], False
    for c, h in zip(contours, hierarchy):
        if h[3] != -1:  # interior contour (hole)
            if tracer.area(c) >= min_area:
                has_holes = True
            continue
        if tracer.area(c) < min_area or len(c) < 3:
            continue
        polys.append(c.reshape(-1).astype(float).tolist())
    return polys, has_holes


class AnnotationConverter:
    def __init__(self, output_dir: str):
        self.output_dir = output_dir
        self.instance_counter = 0
        self.parsers: dict[str, Callable] = {
            "coco": self._parse_coco,
            "separate_masks": self._parse_separate_masks,
        }

    # ------------------------- parsers -------------------------------
    def _parse_coco(self, coco_json: str, **kw) -> Iterator[dict]:
        with open(coco_json) as f:
            coco = json.load(f)
        cats = {c["id"]: c["name"] for c in coco["categories"]}
        label2id = {"background": 0}
        for cid in sorted(cats):
            label2id[cats[cid]] = len(label2id)
        anns = {}
        for a in coco["annotations"]:
            anns.setdefault(a["image_id"], []).append(a)
        for img in coco["images"]:
            instances = []
            for a in anns.get(img["id"], []):
                seg = a["segmentation"]
                if isinstance(seg, dict):
                    m = rle_codec.decode(seg).astype(bool)
                else:
                    m = polygon_to_mask(seg, img["height"], img["width"]).astype(bool)
                instances.append((m, label2id[cats[a["category_id"]]]))
            yield {
                "file_name": img["file_name"],
                "height": img["height"],
                "width": img["width"],
                "instances": instances,
                "label2id": label2id,
            }

    def _parse_separate_masks(self, masks_glob: str, class_id: int = 1, **kw) -> Iterator[dict]:
        """Directory of per-instance binary mask PNGs grouped by image stem
        `<image>__<idx>.png`."""
        by_image: dict[str, list[str]] = {}
        for p in sorted(glob.glob(masks_glob)):
            stem = os.path.basename(p).split("__")[0]
            by_image.setdefault(stem, []).append(p)
        for stem, paths in by_image.items():
            first = load_gray_cv2(paths[0])
            instances = [(load_gray_cv2(p) > 0, class_id) for p in paths]
            yield {
                "file_name": stem + ".png",
                "height": first.shape[0],
                "width": first.shape[1],
                "instances": instances,
                "label2id": {"background": 0, "object": class_id},
            }

    # ------------------------- convert -------------------------------
    def convert(self, parser: str, source, **kw) -> list[dict]:
        """Run a parser and write uint16 3-channel combined masks. Returns the
        meta records."""
        os.makedirs(self.output_dir, exist_ok=True)
        records = []
        for item in self.parsers[parser](source, **kw):
            combined = np.zeros((item["height"], item["width"], 3), np.uint16)
            local_id = 0
            for mask, sem in item["instances"]:
                local_id += 1
                self.instance_counter += 1
                combined[mask, 1] = local_id
                combined[mask, 2] = sem
            out = os.path.join(self.output_dir, os.path.splitext(item["file_name"])[0] + ".png")
            os.makedirs(os.path.dirname(out), exist_ok=True)
            write_png(out, combined, bgr=True)
            records.append(
                {
                    "image": item["file_name"],
                    "annotation": out,
                    "semantic_class_to_id": item["label2id"],
                }
            )
        return records

    def convert_to_coco_json(self, records: list[dict], out_path: str) -> dict:
        """3-channel masks -> COCO JSON with polygon segmentations
        (reference: custom_mask_generator.py:659-886)."""
        images, annotations = [], []
        categories_by_name: dict[str, int] = {}
        ann_id = 0
        for img_id, rec in enumerate(records):
            mask = load_unchanged(rec["annotation"])
            h, w = mask.shape[:2]
            images.append({"id": img_id, "file_name": rec["image"], "height": h, "width": w})
            inst_ch, sem_ch = mask[..., 1], mask[..., 2]
            for iid in np.unique(inst_ch):
                if iid == 0:
                    continue
                m = inst_ch == iid
                sem = int(np.bincount(sem_ch[m]).argmax())
                name = {v: k for k, v in rec["semantic_class_to_id"].items()}.get(sem, str(sem))
                if name not in categories_by_name:
                    categories_by_name[name] = sem
                polys, has_holes = mask_to_polygons(m)
                if not polys:
                    continue
                # Holed instances (donuts) round-trip exactly only as RLE:
                # polygon fill would close the hole (reference handles holes
                # via contour hierarchy, custom_mask_generator.py:86-138).
                seg = rle_codec.encode(m) if has_holes else polys
                ys, xs = np.nonzero(m)
                ann_id += 1
                annotations.append(
                    {
                        "id": ann_id,
                        "image_id": img_id,
                        "category_id": sem,
                        "segmentation": seg,
                        "area": float(m.sum()),
                        "bbox": [float(xs.min()), float(ys.min()), float(xs.max() - xs.min() + 1), float(ys.max() - ys.min() + 1)],
                        "iscrowd": 0,
                    }
                )
        coco = {
            "images": images,
            "annotations": annotations,
            "categories": [{"id": v, "name": k} for k, v in categories_by_name.items()],
        }
        os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
        with open(out_path, "w") as f:
            json.dump(coco, f)
        return coco


def main(argv=None):
    ap = argparse.ArgumentParser(description="Universal annotation converter")
    ap.add_argument("--parser", choices=["coco", "separate_masks"], required=True)
    ap.add_argument("--source", required=True)
    ap.add_argument("--output_dir", required=True)
    ap.add_argument("--meta_out", default=None)
    args = ap.parse_args(argv)
    conv = AnnotationConverter(args.output_dir)
    records = conv.convert(args.parser, args.source)
    if args.meta_out:
        with open(args.meta_out, "w") as f:
            json.dump(records, f, indent=2)
    print(f"converted {len(records)} images, {conv.instance_counter} instances")


if __name__ == "__main__":
    main()
