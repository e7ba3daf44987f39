"""The port's input layer against PIL, cv2 and the JAX package, on the CPU.

- The resize twins (`rgbdseg_torch/ops/resize_exact.py`) are exact against
  PIL BILINEAR, cv2 INTER_LINEAR and PIL NEAREST over the size pairs of
  `tests/test_resize_exact.py`.
- PIL's grayscale and the PNG reader are exact against PIL and cv2.
- The Sobel gradient features are within 1e-6 of the JAX package's, their
  validity mask exact.
- The port's map functions (pixels from the one channel builder on CPU tensors)
  match the JAX package's host builders on files of
  `rgbdseg_tpu.data.synthetic.generate`: pixels within 1e-6 (the JAX package's
  own tolerance for its device builder, `tests/test_data.py`), masks and labels
  exact.
"""

import json
import struct
import zlib

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image
from test_resize_exact import SIZES

from rgbdseg_tpu.config import PreprocessConfig as JPreprocessConfig
from rgbdseg_tpu.data import depth_features as jdf
from rgbdseg_tpu.data import registry as JR
from rgbdseg_tpu.data import synthetic
from rgbdseg_tpu.ops.sobel import gradient_features as j_gradient_features
from rgbdseg_torch.config import PreprocessConfig
from rgbdseg_torch.data import depth_features as tdf
from rgbdseg_torch.data import image_io
from rgbdseg_torch.data import registry as TR
from rgbdseg_torch.data.device_preprocess import pil_grayscale_u8, unpack_masks
from rgbdseg_torch.ops.resize_exact import cv2_resize_linear_u8, pil_resize_nearest, pil_resize_u8
from rgbdseg_torch.ops.sobel import gradient_features


def _images(seed, ih, iw):
    rs = np.random.RandomState(seed)
    return [rs.randint(0, 256, shape, np.uint8) for shape in ((ih, iw), (ih, iw, 3))]


@pytest.mark.parametrize("ih,iw,oh,ow", SIZES)
def test_pil_bilinear_exact(ih, iw, oh, ow):
    for img in _images(ih * 1000 + ow, ih, iw):
        want = np.asarray(Image.fromarray(img).resize((ow, oh), Image.BILINEAR))
        np.testing.assert_array_equal(pil_resize_u8(torch.from_numpy(img), (oh, ow)).numpy(), want)


@pytest.mark.parametrize("ih,iw,oh,ow", SIZES)
def test_cv2_linear_exact(ih, iw, oh, ow):
    for img in _images(ih * 1000 + ow + 7, ih, iw):
        want = cv2.resize(img, (ow, oh), interpolation=cv2.INTER_LINEAR)
        np.testing.assert_array_equal(cv2_resize_linear_u8(torch.from_numpy(img), (oh, ow)).numpy(), want)


@pytest.mark.parametrize("ih,iw,oh,ow", SIZES + [(64, 96, 96, 64), (2, 3, 3, 2)])
def test_pil_nearest_exact(ih, iw, oh, ow):
    """Pillow sums the source step once per pixel in float64; the closed form
    floor((x + 0.5) * in / out) differs from it at (64, 96) -> (96, 64)."""
    for img in _images(ih * 1000 + ow + 11, ih, iw):
        want = np.asarray(Image.fromarray(img).resize((ow, oh), Image.NEAREST))
        np.testing.assert_array_equal(pil_resize_nearest(torch.from_numpy(img), (oh, ow)).numpy(), want)


def test_batched_resizes_match_per_image():
    imgs = np.random.RandomState(3).randint(0, 256, (4, 72, 56, 3), np.uint8)
    t = torch.from_numpy(imgs)
    for fn in (pil_resize_u8, cv2_resize_linear_u8, pil_resize_nearest):
        batched = fn(t, (48, 64)).numpy()
        for i in range(4):
            np.testing.assert_array_equal(batched[i], fn(t[i], (48, 64)).numpy())


def test_pil_grayscale_exact():
    rgb = np.random.RandomState(0).randint(0, 256, (37, 53, 3), dtype=np.uint8)
    want = np.asarray(Image.fromarray(rgb).convert("L"))
    np.testing.assert_array_equal(pil_grayscale_u8(torch.from_numpy(rgb)).numpy(), want)


def _gray_depth(seed, shape):
    """8-bit depth: a tilted plane, a nearer box, flat patches (zero gradient)
    and 5% holes."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0 : shape[-2], 0 : shape[-1]]
    d = np.broadcast_to(120 + 0.7 * yy - 0.4 * xx, shape) + rng.uniform(-3, 3, shape)
    d[..., 5:20, 10:30] = 60
    d = np.clip(np.round(d), 0, 255)
    d[rng.rand(*shape) < 0.05] = 0
    return d.astype(np.float32)


def test_gradient_features_match_jax():
    d = _gray_depth(0, (2, 41, 57))
    got = [t.numpy() for t in gradient_features(torch.from_numpy(d))]
    ref = [np.asarray(a) for a in j_gradient_features(jnp.asarray(d))]
    np.testing.assert_allclose(got[0], ref[0], atol=1e-6, rtol=0)
    for g, r in zip(got[1:], ref[1:]):
        np.testing.assert_array_equal(g, r)
    assert got[3].any() and not got[3].all()


def test_host_depth_features_match_cv2_versions():
    """The float32 features equal cv2's and numpy's bit for bit. The float64
    magnitude differs by an ulp at a few pixels (cv2's and torch's float64
    square roots are not both correctly rounded), hence 1e-12 relative there."""
    d = _gray_depth(1, (39, 50))
    np.testing.assert_allclose(tdf.compute_depth_gradient(d), jdf.compute_depth_gradient(d), rtol=1e-12, atol=0)
    for g, r in zip(tdf.calculate_gradient_features(d), jdf.calculate_gradient_features(d)):
        np.testing.assert_array_equal(g, r)


# ---------------------------------------------------------------- PNG reader

_COLOR_TYPE = {"L": 0, "RGB": 2, "LA": 4, "RGBA": 6}
_PAETH = np.vectorize(lambda a, b, c: a if abs(b - c) <= abs(a - c) and abs(b - c) <= abs(a + b - 2 * c)
                      else (b if abs(a - c) <= abs(a + b - 2 * c) else c))


def _png_all_filters(arr: np.ndarray, mode: str) -> bytes:
    """A PNG whose row y uses filter y % 5 (None, Sub, Up, Average, Paeth),
    which neither PIL nor cv2 choose all of."""
    h, w = arr.shape[:2]
    bpp = 1 if arr.ndim == 2 else arr.shape[2]
    rows = arr.reshape(h, w * bpp).astype(np.int64)
    raw = b""
    for y in range(h):
        x, up = rows[y], rows[y - 1] if y else np.zeros_like(rows[0])
        left = np.concatenate([np.zeros(bpp, np.int64), x[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int64), up[:-bpp]])
        pred = [0, left, up, (left + up) // 2, _PAETH(left, up, upleft)][y % 5]
        raw += bytes([y % 5]) + ((x - pred) % 256).astype(np.uint8).tobytes()

    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, _COLOR_TYPE[mode], 0, 0, 0)
    return b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr) + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b"")


@pytest.mark.parametrize("mode", ["L", "LA", "RGB", "RGBA"])
@pytest.mark.parametrize("content", ["noise", "smooth", "all_filters"])
def test_png_reader_exact(tmp_path, mode, content):
    """read_png returns the samples; load_rgb / load_gray equal PIL's
    convert("RGB") / convert("L"); load_unchanged equals cv2.IMREAD_UNCHANGED."""
    c = len(mode)
    h, w = 23, 31
    if content == "noise":
        arr = np.random.RandomState(c).randint(0, 256, (h, w, c)).astype(np.uint8)
    else:
        yy, xx = np.mgrid[0:h, 0:w]
        arr = np.stack([(3 * yy + 2 * xx + 40 * i) % 256 for i in range(c)], -1).astype(np.uint8)
    arr = arr[..., 0] if c == 1 else arr
    path = str(tmp_path / "x.png")
    if content == "all_filters":
        with open(path, "wb") as f:
            f.write(_png_all_filters(arr, mode))
    else:
        Image.fromarray(arr, mode).save(path)
    np.testing.assert_array_equal(image_io.read_png(path), arr)
    np.testing.assert_array_equal(image_io.load_rgb(path), np.asarray(Image.open(path).convert("RGB")))
    np.testing.assert_array_equal(image_io.load_gray(path), np.asarray(Image.open(path).convert("L")))
    want = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    got = image_io.load_unchanged(path)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_png_reader_keeps_cv2_channel_order_for_masks(tmp_path):
    """An annotation written by cv2 reads back in cv2's (BGR) order, so that
    channels [1:] are (instance, semantic) as the registry slices them."""
    mask = np.zeros((30, 40, 3), np.uint8)
    mask[..., 0] = np.random.RandomState(0).randint(0, 9, (30, 40))
    mask[5:20, 5:30, 1], mask[5:20, 5:30, 2] = 3, 2
    path = str(tmp_path / "m.png")
    cv2.imwrite(path, mask)
    np.testing.assert_array_equal(image_io.load_unchanged(path), mask)
    np.testing.assert_array_equal(image_io.load_unchanged(path), cv2.imread(path, cv2.IMREAD_UNCHANGED))


def test_png_reader_rejects_what_it_does_not_read(tmp_path):
    """Palettes and sub-byte samples raise (16-bit samples are read since the
    tools write them: tests/test_torch_tools.py)."""
    path = str(tmp_path / "p.png")
    Image.fromarray(np.zeros((8, 8), np.uint8)).convert("P").save(path)
    with pytest.raises(ValueError, match="not supported"):
        image_io.read_png(path)
    Image.fromarray(np.zeros((8, 8), bool)).save(path)
    with pytest.raises(ValueError, match="bit depth 1"):
        image_io.read_png(path)
    Image.fromarray(np.zeros((8, 8), np.uint16)).save(path)
    assert image_io.read_png(path).dtype == np.uint16


# ---------------------------------------------------------------- map functions


@pytest.fixture(scope="module", params=[(64, 96), (96, 128), (40, 60)], ids=["target", "downscale", "upscale"])
def fixture_set(request, tmp_path_factory):
    """Files of the JAX package's synthetic generator at a source size; the
    target is 64x96 throughout."""
    root = tmp_path_factory.mktemp("synthetic")
    out = synthetic.generate(str(root), num_train=2, num_valid=0, size=request.param, seed=5)
    with open(out["train"]) as f:
        records = json.load(f)
    for r in records:
        r["image"] = [str(root / p) for p in r["image"]]
        r["annotation"] = str(root / r["annotation"])
    return records


@pytest.mark.parametrize("map_fn", ["map_3channel", "map_10channel_case2"])
def test_map_functions_match_jax_host_builders(fixture_set, map_fn):
    h, w = 64, 96
    for example in fixture_set:
        if map_fn == "map_3channel":
            example = dict(example, image=example["image"][0])
        want = JR.MAP_FUNCTIONS[map_fn](example, JPreprocessConfig(height=h, width=w))
        got = TR.MAP_FUNCTIONS[map_fn](example, PreprocessConfig(height=h, width=w))
        assert got[0].shape == want[0].shape == (h, w, 3 if map_fn == "map_3channel" else 10)
        np.testing.assert_allclose(got[0], want[0], atol=1e-6, rtol=1e-6)
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_array_equal(got[2], want[2])
        assert got[1].shape[0] >= 2  # background and at least one object


def _flip(image, mask):
    return {"image": image[:, ::-1].copy(), "mask": mask[:, ::-1].copy()}


def test_map_function_applies_transform_as_jax(fixture_set, monkeypatch):
    """An installed TRANSFORM (a horizontal flip of the colour frame and the
    annotation; depth untouched, as in the reference) gives the JAX host
    builder's output."""
    monkeypatch.setattr(JR, "TRANSFORM", _flip)
    TR.set_transform(_flip)
    try:
        example = fixture_set[0]
        want = JR.map_10channel_case2(example, JPreprocessConfig(height=64, width=96))
        got = TR.map_10channel_case2(example, PreprocessConfig(height=64, width=96))
    finally:
        TR.set_transform(None)
    np.testing.assert_allclose(got[0], want[0], atol=1e-6, rtol=1e-6)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])


def test_map_function_takes_arrays_as_paths(fixture_set):
    """uint8 frames and a cv2-ordered annotation array give what their files give."""
    example = fixture_set[0]
    arrays = {
        "image": [image_io.load_rgb(example["image"][0]), image_io.read_png(example["image"][1])],
        "annotation": image_io.load_unchanged(example["annotation"]),
    }
    cfg = PreprocessConfig(height=64, width=96)
    for a, b in zip(TR.map_10channel_case2(arrays, cfg), TR.map_10channel_case2(example, cfg)):
        np.testing.assert_array_equal(a, b)


def test_unported_layouts_raise():
    """The two layouts built on the host only (as in the JAX package) raise in
    the device builder; every other layout is built there."""
    from rgbdseg_torch.data import device_preprocess as DP

    for name in ("map_7channel_g", "map_30channel"):
        with pytest.raises(NotImplementedError, match="built on the host"):
            DP.build_pixels(name, torch.zeros(1, 8, 8, 3, dtype=torch.uint8), None, PreprocessConfig())
        assert not DP.supported(name)
    assert DP.supported("map_10channel_case2") and DP.supported("map_7channel_g2")


@pytest.mark.parametrize("src", [(64, 96), (100, 150), (40, 60)])
def test_process_example_matches_jax(src):
    """process_image (PIL BILINEAR, rescale, normalise) and the PIL NEAREST
    instance map of process_example, against the JAX package's PIL versions."""
    from rgbdseg_tpu.data.preprocess import process_example as j_process_example
    from rgbdseg_torch.data.preprocess import process_example

    rng = np.random.RandomState(src[0])
    image = rng.randint(0, 256, src + (3,), np.uint8)
    inst = np.zeros(src, np.uint8)
    inst[src[0] // 4 : src[0] // 2, src[1] // 3 :] = 1
    inst[src[0] // 2 :, : src[1] // 2] = 2
    mapping = {0: 0, 1: 2, 2: 1}
    got = process_example(image, inst, mapping, PreprocessConfig(height=64, width=96))
    want = j_process_example(image, inst, mapping, JPreprocessConfig(height=64, width=96))
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_unpack_masks_inverts_packbits():
    rng = np.random.RandomState(0)
    for h, w in ((8, 8), (45, 67), (1, 3)):
        masks = rng.rand(2, 3, h, w) > 0.5
        packed = np.packbits(masks.reshape(2, 3, -1), axis=-1)
        got = unpack_masks(torch.from_numpy(packed), (h, w))
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), masks.astype(np.float32))
