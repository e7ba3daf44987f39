"""The port's dataset tools against the JAX package's, bit for bit, on the CPU
(`rgbdseg_torch/tools/{dataset_builder,annotation_converter,labelme_coco}.py`
against `rgbdseg_tpu/tools/`, which run cv2).

- 16-bit PNGs (`data/image_io.py`): what cv2 writes reads as cv2 and PIL read
  it, what the port writes reads back in cv2, and a dataset that the JAX
  package's `dataset_constructor` builds (uint16 masks) trains through the
  port's registry and `SegmentationDataset` with the JAX pipeline's labels.
- `polygon_to_mask` (numpy `cv2.fillPoly`) on seeded polygons of every kind.
- `mask_to_polygons` (`native/contours.c`: `cv2.findContours` + `contourArea`)
  on seeded masks: contours, hierarchy and their order, polygons, holes.
- The files of `rasterize_coco`, `dataset_constructor`, both parsers of
  `AnnotationConverter`, `convert_to_coco_json` and the LabelMe converter:
  JSON equal once paths are relative, PNG pixels equal.
"""

import json
import os

import cv2
import numpy as np
import pytest
import torch
from PIL import Image

from rgbdseg_tpu.config import PreprocessConfig as JPreprocessConfig
from rgbdseg_tpu.data import pipeline as JP
from rgbdseg_tpu.inference import rle as jrle
from rgbdseg_tpu.tools import annotation_converter as JA
from rgbdseg_tpu.tools import dataset_builder as JD
from rgbdseg_tpu.tools import labelme_coco as JL
from rgbdseg_torch import native
from rgbdseg_torch.config import PreprocessConfig
from rgbdseg_torch.data import image_io
from rgbdseg_torch.data import pipeline as TP
from rgbdseg_torch.tools import annotation_converter as TA
from rgbdseg_torch.tools import dataset_builder as TD
from rgbdseg_torch.tools import labelme_coco as TL

H, W = 48, 64


def _ring(rng, cx, cy, r, n, wobble=0.0):
    t = np.sort(rng.uniform(0, 2 * np.pi, n))
    rad = r * (1 + wobble * rng.uniform(-1, 1, n))
    return np.stack([cx + rad * np.cos(t), cy + rad * np.sin(t)], 1)


def _polygon(kind: str, rng, h: int, w: int):
    """One seeded COCO polygon (a flat list, or a list of rings) of the kind named."""
    cx, cy = rng.uniform(0, w), rng.uniform(0, h)
    if kind == "convex":
        p = _ring(rng, cx, cy, rng.uniform(2, min(h, w) / 2), rng.randint(3, 12))
    elif kind == "concave":
        p = _ring(rng, cx, cy, rng.uniform(4, min(h, w) / 2), rng.randint(5, 16), wobble=0.6)
    elif kind == "self_intersecting":  # vertices in random order
        p = np.stack([rng.uniform(0, w, 7), rng.uniform(0, h, 7)], 1)
    elif kind == "rings":
        return [_ring(rng, rng.uniform(0, w), rng.uniform(0, h), rng.uniform(2, 15), rng.randint(3, 9), 0.3)
                .reshape(-1).tolist() for _ in range(rng.randint(2, 4))]
    elif kind == "collinear":
        t = np.sort(rng.uniform(-0.5, 1.5, rng.randint(3, 6)))
        p = np.stack([cx + t * rng.uniform(-30, 30), cy + t * rng.uniform(-30, 30)], 1)
    elif kind == "one_point":
        p = np.array([[cx, cy]])
    elif kind == "two_points":
        p = np.stack([rng.uniform(-10, w + 10, 2), rng.uniform(-10, h + 10, 2)], 1)
    elif kind == "outside":
        p = np.stack([rng.uniform(-40, w + 40, 6), rng.uniform(-40, h + 40, 6)], 1)
    else:  # half_integer: vertices at .5, where np.round rounds half to even
        p = np.floor(_ring(rng, cx, cy, rng.uniform(3, 20), rng.randint(3, 9), 0.4)) + 0.5
    return p.reshape(-1).tolist()


POLYGON_KINDS = ("convex", "concave", "self_intersecting", "rings", "collinear", "one_point", "two_points",
                 "outside", "half_integer")


@pytest.mark.parametrize("kind", POLYGON_KINDS)
def test_polygon_to_mask_equals_cv2(kind):
    rng = np.random.RandomState(POLYGON_KINDS.index(kind))
    for _ in range(24):
        h, w = rng.randint(8, 60), rng.randint(8, 60)
        poly = _polygon(kind, rng, h, w)
        np.testing.assert_array_equal(TD.polygon_to_mask(poly, h, w), JD.polygon_to_mask(poly, h, w))


def _mask(kind: str, rng, h: int, w: int) -> np.ndarray:
    m = np.zeros((h, w), np.uint8)
    if kind == "blobs":
        for _ in range(rng.randint(1, 6)):
            cv2.ellipse(m, (int(rng.randint(0, w)), int(rng.randint(0, h))),
                        (int(rng.randint(1, 12)), int(rng.randint(1, 12))), float(rng.uniform(0, 180)), 0, 360, 1, -1)
    elif kind in ("donuts", "island_in_hole"):
        for _ in range(rng.randint(1, 4)):
            c, r = (int(rng.randint(0, w)), int(rng.randint(0, h))), int(rng.randint(4, 16))
            cv2.circle(m, c, r, 1, -1)
            cv2.circle(m, c, r // 2, 0, -1)
            if kind == "island_in_hole":
                cv2.circle(m, c, r // 5, 1, -1)
    elif kind == "border":
        m[: rng.randint(1, h), : rng.randint(1, w)] = 1
        m[rng.randint(0, h):, rng.randint(0, w):] = 1
    elif kind == "pixels":
        m[rng.randint(0, h, 8), rng.randint(0, w, 8)] = 1
    elif kind == "lines":
        m[rng.randint(0, h), :] = 1
        m[:, rng.randint(0, w)] = 1
        m[rng.randint(0, h), rng.randint(0, w // 2):rng.randint(w // 2, w)] = 0
    else:  # noise: many small components, holes and islands
        m = (rng.rand(h, w) < rng.uniform(0.3, 0.8)).astype(np.uint8)
    return m


MASK_KINDS = ("blobs", "donuts", "island_in_hole", "border", "pixels", "lines", "noise")


@pytest.mark.parametrize("kind", MASK_KINDS)
def test_contours_and_polygons_equal_cv2(kind):
    rng = np.random.RandomState(100 + MASK_KINDS.index(kind))
    tracer = native.contours()
    for _ in range(20):
        m = _mask(kind, rng, rng.randint(4, 50), rng.randint(4, 50))
        want_c, want_h = cv2.findContours(m, cv2.RETR_CCOMP, cv2.CHAIN_APPROX_SIMPLE)
        got_c, got_h = tracer.find(m)
        assert len(got_c) == len(want_c)
        for a, b in zip(got_c, want_c):
            np.testing.assert_array_equal(a, b)
            assert tracer.area(a) == cv2.contourArea(b)
        np.testing.assert_array_equal(got_h, want_h[0] if want_h is not None else np.zeros((0, 4), np.int32))
        for min_area in (1.0, 4.0, 20.0):
            assert TA.mask_to_polygons(m, min_area) == JA.mask_to_polygons(m, min_area)


def test_contour_order_of_a_holed_square_and_a_blob():
    """cv2 lists the blob found last first, then the square, then its hole."""
    m = np.zeros((30, 30), np.uint8)
    m[5:20, 5:20] = 1
    m[9:15, 9:15] = 0
    m[24:26, 10:12] = 1
    got, hierarchy = native.contours().find(m)
    assert [c[0, 0].tolist() for c in got] == [[10, 24], [5, 5], [8, 9]]
    assert hierarchy.tolist() == [[1, -1, -1, -1], [-1, 0, 2, -1], [-1, -1, -1, 1]]


def _png(arr: np.ndarray, ctype: int, depth: int) -> bytes:
    """A PNG of the array's samples as they are (no channel reversal)."""
    import struct
    import zlib

    h = arr.shape[0]
    rows = np.ascontiguousarray(arr, ">u2" if depth == 16 else np.uint8).reshape(h, -1).view(np.uint8).reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], 1).tobytes()

    def chunk(t, b):
        return struct.pack(">I", len(b)) + t + b + struct.pack(">I", zlib.crc32(t + b) & 0xFFFFFFFF)

    header = struct.pack(">IIBBBBB", arr.shape[1], h, depth, ctype, 0, 0, 0)
    return b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", header) + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b"")


@pytest.mark.parametrize("depth", [8, 16])
@pytest.mark.parametrize("ctype,channels", [(0, 1), (4, 2), (2, 3), (6, 4)])
def test_png_reads_equal_cv2_and_pil(tmp_path, depth, ctype, channels):
    rng = np.random.RandomState(depth + ctype)
    shape = (13, 17) if channels == 1 else (13, 17, channels)
    arr = rng.randint(0, 1 << depth, shape)
    arr[:3] = np.minimum(arr[:3], 300)  # 16-bit samples around PIL's clip at 255
    if channels >= 3:
        arr[3:5, :, 1] = arr[3:5, :, 2] = arr[3:5, :, 0]  # equal channels keep their value in gray
    path = str(tmp_path / "x.png")
    with open(path, "wb") as f:
        f.write(_png(arr, ctype, depth))
    pairs = {
        "unchanged": (image_io.load_unchanged(path), cv2.imread(path, cv2.IMREAD_UNCHANGED)),
        "color": (image_io.load_color(path), cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB)),
        "gray_cv2": (image_io.load_gray_cv2(path), cv2.imread(path, cv2.IMREAD_GRAYSCALE)),
        "rgb": (image_io.load_rgb(path), np.asarray(Image.open(path).convert("RGB"))),
        "gray": (image_io.load_gray(path), np.asarray(Image.open(path).convert("L"))),
    }
    for name, (got, want) in pairs.items():
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    assert image_io.png_header(path) == (13, 17, depth)


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
@pytest.mark.parametrize("shape", [(9, 11), (9, 11, 3), (9, 11, 4)])
def test_bgr_writer_equals_cv2_imwrite(tmp_path, dtype, shape):
    arr = np.random.RandomState(len(shape)).randint(0, np.iinfo(dtype).max + 1, shape).astype(dtype)
    ours, theirs = str(tmp_path / "ours.png"), str(tmp_path / "cv2.png")
    image_io.write_png(ours, arr, bgr=True)
    cv2.imwrite(theirs, arr)
    np.testing.assert_array_equal(cv2.imread(ours, cv2.IMREAD_UNCHANGED), arr)
    np.testing.assert_array_equal(image_io.read_png(ours), image_io.read_png(theirs))
    image_io.write_png(ours, arr)
    np.testing.assert_array_equal(image_io.read_png(ours), arr)


def _coco_set(root, rng, n: int = 5, h: int = H, w: int = W) -> str:
    """A seeded COCO JSON under `root` with RGB and depth PNGs: polygons of
    several kinds (one touching the border), multi-ring polygons and RLE donuts,
    3 categories with ids out of order."""
    os.makedirs(root / "images", exist_ok=True)
    os.makedirs(root / "depth", exist_ok=True)
    images, annotations = [], []
    for i in range(n):
        name = f"{i}.png"
        cv2.imwrite(str(root / "images" / name), rng.randint(0, 256, (h, w, 3), np.uint8))
        cv2.imwrite(str(root / "depth" / name), rng.randint(0, 256, (h, w), np.uint8))
        images.append({"id": 10 + i, "file_name": name, "height": h, "width": w})
        for k in range(rng.randint(3, 7)):
            kind = ("convex", "concave", "rings", "outside", "donut")[k % 5]
            if kind == "donut":
                m = np.zeros((h, w), np.uint8)
                c, r = (int(rng.randint(8, w - 8)), int(rng.randint(8, h - 8))), int(rng.randint(5, 9))
                cv2.circle(m, c, r, 1, -1)
                cv2.circle(m, c, r // 2, 0, -1)
                seg = jrle.encode(m)
            else:
                seg = _polygon(kind, rng, h, w)
                seg = seg if kind == "rings" else [seg]
            annotations.append({"id": len(annotations) + 1, "image_id": 10 + i, "category_id": (7, 3, 5)[k % 3],
                                "segmentation": seg, "iscrowd": 0})
    coco = {"images": images, "annotations": annotations,
            "categories": [{"id": 7, "name": "cup"}, {"id": 3, "name": "box"}, {"id": 5, "name": "can"}]}
    path = root / "coco.json"
    path.write_text(json.dumps(coco))
    return str(path)


def _relative(obj, *roots):
    """JSON with each root prefix of a string path replaced by its index."""
    if isinstance(obj, dict):
        return {k: _relative(v, *roots) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_relative(v, *roots) for v in obj]
    if isinstance(obj, str):
        for i, r in enumerate(roots):
            obj = obj.replace(str(r), f"<{i}>")
    return obj


def _pixels_equal(a: str, b: str) -> None:
    x, y = cv2.imread(a, cv2.IMREAD_UNCHANGED), cv2.imread(b, cv2.IMREAD_UNCHANGED)
    assert x.dtype == y.dtype and x.shape == y.shape, (a, x.dtype, x.shape, y.dtype, y.shape)
    np.testing.assert_array_equal(x, y)


def test_dataset_constructor_files_equal_jax(tmp_path):
    coco = _coco_set(tmp_path / "src", np.random.RandomState(7))
    out_j, out_t = tmp_path / "jax", tmp_path / "torch"
    want = JD.dataset_constructor(coco, str(tmp_path / "src" / "images"), str(out_j), seed=3)
    got = TD.dataset_constructor(coco, str(tmp_path / "src" / "images"), str(out_t), seed=3)
    assert _relative(got, out_t) == _relative(want, out_j)
    for key in ("train", "valid", "label2id"):
        assert _relative(json.loads(open(got[key]).read()), out_t) == _relative(json.loads(open(want[key]).read()),
                                                                             out_j)
    masks = sorted(os.listdir(out_j / "mask"))
    assert masks == sorted(os.listdir(out_t / "mask")) and len(masks) == 5
    for name in masks:
        _pixels_equal(str(out_t / "mask" / name), str(out_j / "mask" / name))
        assert cv2.imread(str(out_t / "mask" / name), cv2.IMREAD_UNCHANGED).dtype == np.uint16


def test_annotation_converter_both_parsers_and_back_equal_jax(tmp_path):
    rng = np.random.RandomState(11)
    coco = _coco_set(tmp_path / "src", rng)
    # the separate-mask parser's input: per-instance PNGs, gray and colour, 8- and 16-bit
    sep = tmp_path / "sep"
    sep.mkdir()
    for i in range(3):
        for k in range(3):
            m = _mask(("blobs", "donuts", "island_in_hole")[k], rng, H, W)
            # 8-bit gray; 16-bit gray; dark blue BGR, which cv2's gray keeps nonzero at 9 and up
            arr = [m * 255, m.astype(np.uint16) * 60000, np.stack([m * rng.randint(1, 20), m * 0, m * 0], -1)][k]
            cv2.imwrite(str(sep / f"im{i}__{k}.png"), arr)
    for parser, source in (("coco", coco), ("separate_masks", str(sep / "*.png"))):
        jc, tc = JA.AnnotationConverter(str(tmp_path / "j" / parser)), TA.AnnotationConverter(str(tmp_path / "t" / parser))
        want, got = jc.convert(parser, source), tc.convert(parser, source)
        assert _relative(got, tmp_path / "t") == _relative(want, tmp_path / "j")
        assert tc.instance_counter == jc.instance_counter
        for a, b in zip(got, want):
            _pixels_equal(a["annotation"], b["annotation"])
        coco_j = jc.convert_to_coco_json(want, str(tmp_path / "j" / f"{parser}.json"))
        coco_t = tc.convert_to_coco_json(got, str(tmp_path / "t" / f"{parser}.json"))
        assert coco_t == coco_j
        assert json.loads((tmp_path / "t" / f"{parser}.json").read_text()) == coco_j
        assert any(isinstance(a["segmentation"], dict) for a in coco_j["annotations"]) or parser != "coco"


def test_labelme_converter_equals_jax(tmp_path):
    rng = np.random.RandomState(5)
    src = tmp_path / "labelme"
    src.mkdir()
    for i in range(3):
        shapes = [{"label": ("cup", "box")[k % 2], "points": _ring(rng, 30, 20, 9, 6, 0.4).tolist()}
                  for k in range(rng.randint(1, 4))]
        (src / f"f{i}.json").write_text(json.dumps({"imagePath": f"f{i}.png", "imageHeight": H, "imageWidth": W,
                                                    "shapes": shapes}))
    want = JL.convert_labelme_to_coco(str(src), str(tmp_path / "j.json"))
    assert TL.convert_labelme_to_coco(str(src), str(tmp_path / "t.json")) == want
    assert (tmp_path / "t.json").read_bytes() == (tmp_path / "j.json").read_bytes()
    records = [{"image": f"images/f{i}.png", "annotation": f"mask/f{i}.png"} for i in range(3)]
    assert TL.build_multimodal_meta(records, ["depth"], str(tmp_path / "tm.json")) == \
        JL.build_multimodal_meta(records, ["depth"], str(tmp_path / "jm.json"))


@pytest.mark.parametrize("version", ["0.0.0", "0.4.0"])
def test_jax_built_dataset_trains_through_the_port(tmp_path, version):
    """The JAX package's dataset_constructor writes 16-bit masks; the port's
    registry and SegmentationDataset read them to the JAX pipeline's labels."""
    coco = _coco_set(tmp_path / "src", np.random.RandomState(3))
    fx = JD.dataset_constructor(coco, str(tmp_path / "src" / "images"), str(tmp_path / "set"), train_ratio=0.6)
    records = json.loads(open(fx["train"]).read()) + json.loads(open(fx["valid"]).read())
    if version == "0.4.0":  # [rgb, depth] records (the reference's multi-modality meta)
        records = JL.build_multimodal_meta(records, [str(tmp_path / "src" / "depth")], str(tmp_path / "m.json"))
    want = JP.SegmentationDataset(records, version, JPreprocessConfig(height=32, width=40), max_instances=8)
    got = TP.SegmentationDataset(json.loads(json.dumps(records)), version, PreprocessConfig(height=32, width=40),
                                 max_instances=8)
    assert len(got) == len(want) == 5
    for i in range(len(got)):
        (gp, gm, gc, gv), (wp, wm, wc, wv) = got[i], want[i]
        np.testing.assert_array_equal(gm, np.asarray(wm))
        np.testing.assert_array_equal(gc, np.asarray(wc))
        np.testing.assert_array_equal(gv, np.asarray(wv))
        np.testing.assert_allclose(gp, np.asarray(wp), atol=1e-6)
        assert gv.sum() > 0
    assert torch.from_numpy(got[0][1]).dtype == torch.float32
