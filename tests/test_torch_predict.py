"""The port's predict surface against the JAX package, on the CPU.

Held here, with their tolerances:
- RLE (`inference/rle.py`): counts, strings, `area` and `mask_iou` equal to
  `rgbdseg_tpu.inference.rle`'s, bit for bit, on hypothesis-generated masks,
  through the native codec (built here with `cc`) and the numpy one; without a
  C compiler the numpy codec runs and says so, and a compiler that fails
  raises;
- `write_png` reads back identically through PIL, cv2 and `read_png`, for
  gray, RGB and RGBA at odd sizes;
- `predictions_to_json`, `gt_to_json` and `process_prediction`: the JSON files
  byte for byte and the comparison PNGs pixel for pixel (cv2's in the JAX
  package, `write_png` here), once both packages post-process with one
  function; with each package's own post-processing the masks and labels are
  equal and the scores within one unit of their sixth decimal (float32
  softmax and sigmoid in another implementation, then rounded to 6 decimals);
- `match_predictions_to_gt`: equal triples;
- `Predictor.predict_and_overlay_files` on a PNG pair of
  `rgbdseg_tpu.data.synthetic.generate` and `predict_and_overlay` (0.0.0 from
  an array): the same labels, scores within 1e-5, overlays >= 99.9%
  pixel-equal, as `predict_example` is held in `tests/test_torch_eval.py`;
- `train.trainer.predict` and `save_metrics`;
- the model's first convolution sees the same strides whatever the layout of
  the stack it is given (the card's logits then depend on its values only:
  `tests/test_torch_kernels.py::test_cuda_forward_depends_on_input_values_only`).
"""

import json
import os

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from PIL import Image

from rgbdseg_tpu.config import ModelConfig as JConfig
from rgbdseg_tpu.config import PreprocessConfig as JPreprocessConfig
from rgbdseg_tpu.data import synthetic
from rgbdseg_tpu.inference import export as jexport
from rgbdseg_tpu.inference import rle as jrle
from rgbdseg_tpu.inference import visualize as jvis
from rgbdseg_tpu.inference.postprocess import post_process_instance_segmentation as j_post_process
from rgbdseg_tpu.inference.predictor import Predictor as JPredictor
from rgbdseg_tpu.models.mask2former import Mask2FormerRGBD as JModel
from rgbdseg_tpu.train.trainer import save_metrics as j_save_metrics
from rgbdseg_torch import native
from rgbdseg_torch.config import ModelConfig, PreprocessConfig
from rgbdseg_torch.data.image_io import read_png, write_png
from rgbdseg_torch.data.pipeline import Batch
from rgbdseg_torch.inference import export as texport
from rgbdseg_torch.inference import rle as trle
from rgbdseg_torch.inference import visualize as tvis
from rgbdseg_torch.inference.predictor import Predictor
from rgbdseg_torch.models.mask2former import Mask2FormerRGBD
from rgbdseg_torch.train.trainer import evaluate, predict, save_metrics
from rgbdseg_torch.utils.weights import from_flax

HW = 64
NUM_LABELS = 3
ID2LABEL = {0: "background", 1: "box", 2: "ball"}

# ---------------------------------------------------------------- RLE


masks_st = st.integers(1, 24).flatmap(
    lambda h: st.integers(1, 24).flatmap(
        lambda w: st.lists(st.booleans(), min_size=h * w, max_size=h * w).map(
            lambda bits: np.asarray(bits, bool).reshape(h, w))))


@settings(max_examples=60, deadline=None)
@given(masks_st, masks_st)
def test_rle_matches_jax_for_both_codecs(a, b):
    """Counts, strings, decode, area and IoU equal to the JAX package's, through
    the native codec and the numpy one (the plain version)."""
    assert native.rle() is not None  # this box has cc: the native codec is in use
    counts = trle.mask_to_counts(a)
    np.testing.assert_array_equal(counts, jrle.mask_to_counts(a))
    ref = jrle.encode_counts_string(jrle.mask_to_counts(a))
    assert trle.encode_counts_string(counts) == trle._encode_counts_np(counts) == ref
    np.testing.assert_array_equal(trle.decode_counts_string(ref), jrle.decode_counts_string(ref))
    np.testing.assert_array_equal(trle._decode_counts_np(ref), jrle.decode_counts_string(ref))
    ra, rb = trle.encode(a), trle.encode(b)
    assert ra == jrle.encode(a)
    np.testing.assert_array_equal(trle.decode(ra), a.astype(np.uint8))
    assert trle.area(ra) == jrle.area(ra) == int(a.sum())
    if a.shape == b.shape:
        assert trle.mask_iou(ra, rb) == jrle.mask_iou(ra, rb)


def test_rle_large_counts_and_deltas():
    """Counts past 2^31 and large negative deltas: both codecs as the JAX numpy one."""
    counts = np.asarray([0, 3, 2**33 + 5, 1, 7, 2**40, 2, 9], np.int64)
    s = jrle.encode_counts_string(counts)
    assert native.rle().encode(counts) == trle._encode_counts_np(counts) == s
    np.testing.assert_array_equal(native.rle().decode(s), counts)
    with pytest.raises(ValueError, match="ends inside a count"):
        trle.decode_counts_string(s + "P")  # "P" carries the continuation bit, and nothing follows


def test_rle_codec_says_which_and_never_hides_a_failed_build(monkeypatch):
    monkeypatch.setattr(native, "_RLE", [])
    monkeypatch.setenv("CC", "no-such-compiler-here")
    assert trle.codec().startswith("numpy (no C compiler")
    mask = np.eye(7, 9, dtype=bool)
    assert trle.encode(mask) == jrle.encode(mask)
    monkeypatch.setattr(native, "_RLE", [])
    monkeypatch.setenv("CC", "false")  # found, and fails
    with pytest.raises(RuntimeError, match="failed to build"):
        trle.codec()
    monkeypatch.setattr(native, "_RLE", [])
    monkeypatch.delenv("CC")
    assert trle.codec().startswith("native (librle-")


# ---------------------------------------------------------------- PNG writer


@pytest.mark.parametrize("shape", [(7, 13), (9, 11, 3), (5, 3, 4), (1, 1), (33, 17, 3)])
def test_write_png_reads_back_through_pil_cv2_and_read_png(tmp_path, shape):
    a = np.random.RandomState(sum(shape)).randint(0, 256, shape).astype(np.uint8)
    path = str(tmp_path / "x.png")
    write_png(path, a)
    np.testing.assert_array_equal(read_png(path), a)
    np.testing.assert_array_equal(np.asarray(Image.open(path)), a)
    via_cv2 = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    if a.ndim == 3:
        via_cv2 = cv2.cvtColor(via_cv2, cv2.COLOR_BGR2RGB if shape[-1] == 3 else cv2.COLOR_BGRA2RGBA)
    np.testing.assert_array_equal(via_cv2, a)


@pytest.mark.parametrize("bad", [np.zeros((4, 4, 2), np.uint8), np.zeros((4, 4), np.float32),
                                 np.zeros((0, 4), np.uint8)])
def test_write_png_rejects_what_it_does_not_write(tmp_path, bad):
    with pytest.raises(ValueError):
        write_png(str(tmp_path / "x.png"), bad)


# ---------------------------------------------------------------- export and visualisation


class TinySet:
    """The duck-typed dataset both packages' export reads: float stacks at
    HW x HW, padded instance masks, and an original size and RGB of
    `orig` for the first examples."""

    def __init__(self, rng, n=3, t=4, orig=(45, 67)):
        self.items, self.orig = [], orig
        for _ in range(n):
            pix = rng.randn(HW, HW, 10).astype(np.float32)
            masks = np.zeros((t, HW, HW), np.float32)
            valid = np.zeros(t, bool)
            for j in range(rng.randint(1, t + 1)):
                y0, x0 = rng.randint(0, HW // 2, 2)
                masks[j, y0 : y0 + rng.randint(4, HW // 2), x0 : x0 + rng.randint(4, HW // 2)] = 1.0
                valid[j] = True
            self.items.append((pix, masks, rng.randint(0, NUM_LABELS, t).astype(np.int64), valid))
        self.rgbs = [rng.randint(0, 256, (*orig, 3)).astype(np.uint8) for _ in range(n)]

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]

    def original_size(self, i):
        return self.orig if i < 2 else (HW, HW)

    def original_rgb(self, i):
        return self.rgbs[i]


def _logit_batches(rng, sizes=(2, 2)):
    q = 10
    return [(rng.randn(b, q, NUM_LABELS + 1).astype(np.float32) * 2, rng.randn(b, q, 16, 16).astype(np.float32) * 3)
            for b in sizes]


def _export(module, tmp_path, name, outputs, dataset):
    paths = {k: str(tmp_path / name / k) for k in ("pred.json", "gt.json", "cmp")}
    res = module.process_prediction(outputs, dataset, ID2LABEL, paths["pred.json"], paths["gt.json"], paths["cmp"],
                                    threshold=0.0)
    return res, paths


def test_process_prediction_json_and_pngs_equal_jax(tmp_path, monkeypatch):
    """Three examples in batches of 2 (the last one padded): post-processed at
    each original size (45x67 for two, the stack's 64x64 for the third). With
    one post-processing function for both packages, the prediction and GT
    JSON are equal byte for byte and the comparison PNGs pixel for pixel;
    with the port's own, masks and labels equal and scores within one unit of
    their sixth decimal."""
    rng = np.random.RandomState(0)
    data = TinySet(rng)
    outputs = _logit_batches(rng)
    j_res, j_paths = _export(jexport, tmp_path, "jax", outputs, data)
    t_res, t_paths = _export(texport, tmp_path, "own", outputs, data)
    for a, b in zip(j_res, t_res):
        np.testing.assert_array_equal(a["segmentation"], b["segmentation"])
        assert [s["label_id"] for s in a["segments_info"]] == [s["label_id"] for s in b["segments_info"]]
        np.testing.assert_allclose([s["score"] for s in a["segments_info"]], [s["score"] for s in b["segments_info"]],
                                   atol=1.5e-6, rtol=0)
    assert t_res[0]["segmentation"].shape[1:] == (45, 67) and t_res[2]["segmentation"].shape[1:] == (HW, HW)

    def shared(cls_logits, mask_logits, **kw):  # the JAX package's post-processing, given the port's tensors
        return j_post_process(np.asarray(cls_logits), np.asarray(mask_logits), **kw)

    monkeypatch.setattr(texport, "post_process_instance_segmentation", shared)
    t_res, t_paths = _export(texport, tmp_path, "port", outputs, data)
    for k in ("pred.json", "gt.json"):
        with open(t_paths[k], "rb") as f, open(j_paths[k], "rb") as g:
            assert f.read() == g.read(), k
    assert len(json.load(open(t_paths["gt.json"]))) == sum(int(v.sum()) for *_, v in data.items)
    files = sorted(os.listdir(j_paths["cmp"]))
    assert files == sorted(os.listdir(t_paths["cmp"])) == [f"comparison_{i}.png" for i in range(3)]
    for f in files:
        got = read_png(os.path.join(t_paths["cmp"], f))
        np.testing.assert_array_equal(got, np.asarray(Image.open(os.path.join(j_paths["cmp"], f))))
        assert got.shape == ((45, 67 * 3, 3) if f != "comparison_2.png" else (HW, HW * 3, 3))


def test_predictions_to_json_and_match_equal_jax():
    rng = np.random.RandomState(1)
    results = []
    for _ in range(2):
        seg = (rng.rand(5, 20, 30) > 0.6).astype(np.uint8)
        results.append({"segmentation": seg, "segments_info": [
            {"id": k, "label_id": int(rng.randint(0, 3)), "was_fused": False, "score": round(float(rng.rand()), 6)}
            for k in range(5)]})
    assert json.dumps(texport.predictions_to_json(results, [7, 9])) == \
        json.dumps(jexport.predictions_to_json(results, [7, 9]))
    pred = [m for m in (rng.rand(6, 12, 12) > 0.5)]
    gt = [np.maximum(p, rng.rand(12, 12) > 0.8) for p in pred[:4]] + [rng.rand(12, 12) > 0.5]
    for thr in (0.0, 0.5, 0.7):
        got = texport.match_predictions_to_gt(pred, gt, thr)
        assert got == jexport.match_predictions_to_gt(pred, gt, thr) and (thr > 0.5 or got)
    assert texport.match_predictions_to_gt([], gt) == []


def test_overlay_instances_equal_jax():
    rng = np.random.RandomState(2)
    img = rng.randint(0, 256, (21, 33, 3)).astype(np.uint8)
    masks = rng.rand(4, 21, 33) > 0.5
    np.testing.assert_array_equal(tvis.overlay_instances(img, masks), jvis.overlay_instances(img, masks))
    colors = [tvis._color_for(i + 3) for i in range(4)]
    np.testing.assert_array_equal(tvis.overlay_instances(img, masks, colors, 0.3),
                                  jvis.overlay_instances(img, masks, colors, 0.3))


# ---------------------------------------------------------------- the predictor's overlays and trainer.predict


@pytest.fixture(scope="module")
def tiny():
    """(JAX config, JAX variables, the port's state dict with them loaded)."""
    cfg = JConfig.tiny(num_labels=NUM_LABELS, version="0.4.0")
    v = jax.jit(JModel(cfg).init)({"params": jax.random.PRNGKey(1)}, jnp.zeros((1, HW, HW, 10), jnp.float32))
    v = jax.tree.map(lambda a: np.asarray(a).copy(), v)
    model = Mask2FormerRGBD(ModelConfig.tiny(num_labels=NUM_LABELS, version="0.4.0"))
    model.load_state_dict(from_flax(v["params"], v.get("batch_stats")), strict=True)
    return cfg, v, model.eval()


def _same_result(out, ref, vis, jvis_):
    assert out["segments_info"]
    assert [s["label_id"] for s in out["segments_info"]] == [s["label_id"] for s in ref["segments_info"]]
    np.testing.assert_allclose([s["score"] for s in out["segments_info"]],
                               [s["score"] for s in ref["segments_info"]], atol=1e-5)
    assert vis.shape == jvis_.shape
    assert (vis == jvis_).all(axis=-1).mean() >= 0.999


def test_predict_and_overlay_files_matches_jax(tiny, tmp_path):
    """A 96x128 RGB and depth PNG pair of the JAX package's synthetic set,
    served at 64x64: the overlay at the RGB's 96x128, written as PNG."""
    cfg, v, model = tiny
    paths = synthetic.generate(str(tmp_path / "set"), num_train=1, num_valid=0, size=(96, 128), seed=3)
    meta = json.load(open(os.path.join(tmp_path / "set", "train.json")))[0]
    files = [os.path.join(tmp_path / "set", p) for p in meta["image"]]
    jp = JPredictor(cfg, v["params"], v.get("batch_stats"), preprocess=JPreprocessConfig(height=HW, width=HW))
    pred = Predictor(ModelConfig.tiny(num_labels=NUM_LABELS, version="0.4.0"), state_dict=model.state_dict(),
                     device="cpu", preprocess=PreprocessConfig(height=HW, width=HW))
    ref, jvis_ = jp.predict_and_overlay_files(files, threshold=0.0, save=str(tmp_path / "jax.png"))
    out, vis = pred.predict_and_overlay_files(files, threshold=0.0, save=str(tmp_path / "port" / "port.png"))
    assert paths and vis.shape == (96, 128, 3)
    _same_result(out, ref, vis, jvis_)
    np.testing.assert_array_equal(read_png(str(tmp_path / "port" / "port.png")), vis)
    np.testing.assert_array_equal(np.asarray(Image.open(str(tmp_path / "jax.png"))), jvis_)


def test_predict_and_overlay_rgb_only_matches_jax(tmp_path):
    cfg = JConfig.tiny(num_labels=NUM_LABELS, version="0.0.0")
    v = jax.jit(JModel(cfg).init)({"params": jax.random.PRNGKey(2)}, jnp.zeros((1, HW, HW, 3), jnp.float32))
    v = jax.tree.map(lambda a: np.asarray(a).copy(), v)
    model = Mask2FormerRGBD(ModelConfig.tiny(num_labels=NUM_LABELS, version="0.0.0"))
    model.load_state_dict(from_flax(v["params"], v.get("batch_stats")), strict=True)
    img = np.random.RandomState(5).randint(0, 256, (50, 70, 3)).astype(np.uint8)
    jp = JPredictor(cfg, v["params"], v.get("batch_stats"), preprocess=JPreprocessConfig(height=HW, width=HW))
    pred = Predictor(ModelConfig.tiny(num_labels=NUM_LABELS, version="0.0.0"), state_dict=model.state_dict(),
                     device="cpu", preprocess=PreprocessConfig(height=HW, width=HW))
    ref, jvis_ = jp.predict_and_overlay(img, threshold=0.0)
    out, vis = pred.predict_and_overlay(img, threshold=0.0, save=str(tmp_path / "o.png"))
    assert vis.shape == (50, 70, 3)
    _same_result(out, ref, vis, jvis_)
    np.testing.assert_array_equal(read_png(str(tmp_path / "o.png")), vis)


def test_trainer_predict_cuts_padding_and_equals_evaluate(tiny, tmp_path):
    """Two batches of 2 rows for 3 examples (the last row padding): the host
    logits of the 3 real rows equal the eval-mode forward's, the metrics
    equal `evaluate`'s under the "test_" prefix, and `save_metrics` writes
    the JAX package's files byte for byte."""
    _, _, model = tiny
    rng = np.random.RandomState(6)
    data = TinySet(rng)
    rows = [data[i] for i in (0, 1, 2, 2)]
    batches = [Batch(np.stack([r[0] for r in rows[s:s + 2]]), np.stack([r[1] for r in rows[s:s + 2]]),
                     np.stack([r[2] for r in rows[s:s + 2]]), np.stack([r[3] for r in rows[s:s + 2]]))
               for s in (0, 2)]
    outputs, metrics = predict(model, batches, ID2LABEL, num_examples=3)
    assert [o[0].shape[0] for o in outputs] == [2, 1]
    with torch.no_grad():
        ref = model(torch.from_numpy(batches[1].pixel_values))
    np.testing.assert_array_equal(outputs[1][1], ref.masks_queries_logits[:1].numpy())
    again = evaluate(model, batches, ID2LABEL, prefix="test_")
    timing = ("test_runtime", "test_samples_per_second")
    assert {k: v for k, v in metrics.items() if k not in timing} == {k: v for k, v in again.items() if k not in timing}
    for split, m in (("test", {"a": 1.5, "b": 2}), ("eval", {"c": 3.0})):
        save_metrics(str(tmp_path / "port"), split, m)
        j_save_metrics(str(tmp_path / "jax"), split, m)
    for f in ("test_results.json", "eval_results.json", "all_results.json"):
        assert open(tmp_path / "port" / f).read() == open(tmp_path / "jax" / f).read()


def test_first_convolution_sees_one_layout(tiny):
    """numpy's `a[None]` has batch stride 0, which makes torch run the first
    convolution in NCHW where a full batch stride makes it NHWC; the model
    gives both the standard strides."""
    _, _, model = tiny
    x = np.random.RandomState(7).randn(HW, HW, 10).astype(np.float32)
    seen = []
    hook = model.pixel_level_module.encoder.patch_embed.register_forward_pre_hook(
        lambda m, args: seen.append(args[0].stride()))
    try:
        with torch.no_grad():
            for t in (torch.from_numpy(x[None]), torch.from_numpy(x[None]).clone(memory_format=torch.contiguous_format)):
                model(t)
    finally:
        hook.remove()
    assert seen[0] == seen[1] and seen[0][0] != 0


def test_multi_model_grids_equal_jax(tmp_path):
    """`visualize_multi_model_json_results` draws its row with `utils/raster.py`
    (the card's machine has no matplotlib): the JAX package's file names, and
    each panel the overlay the JAX package's figure shows ("GT" in its
    instances' colours, then the model with matched predictions in their GT
    instance's colour and unmatched ones red), pixel for pixel."""
    rng = np.random.RandomState(9)
    gt = [{"segmentation": (rng.rand(3, 24, 32) > 0.6).astype(np.uint8),
           "segments_info": [{"label_id": 1, "score": 1.0}] * 3} for _ in range(2)]
    pred = [{"segmentation": np.maximum(r["segmentation"], rng.rand(3, 24, 32) > 0.9).astype(np.uint8),
             "segments_info": [{"label_id": 1, "score": 0.5}] * 3} for r in gt]
    paths = {}
    for name, res in (("gt", gt), ("model_a", pred)):
        paths[name] = str(tmp_path / f"{name}.json")
        with open(paths[name], "w") as f:
            json.dump(texport.predictions_to_json(res, [0, 1]), f)
    for module, out in ((tvis, "port"), (jvis, "jax")):
        module.visualize_multi_model_json_results(paths["gt"], {"model_a": paths["model_a"]}, str(tmp_path / out))
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "jax")) == \
        ["compare_0.png", "compare_1.png"]
    records = {name: json.loads(open(path).read()) for name, path in paths.items()}
    base = np.full((24, 32, 3), 40, np.uint8)
    for i in (0, 1):
        got = np.asarray(Image.open(tmp_path / "port" / f"compare_{i}.png"))
        assert got.shape == (tvis.TITLE_H + 24, 2 * 32 + tvis.PANEL_GAP, 3)
        gmasks, pmasks = ([jrle.decode(r["segmentation"]) for r in records[name] if r["image_id"] == i]
                          for name in ("gt", "model_a"))
        gt_colors = [jvis._color_for(k) for k in range(len(gmasks))]
        colors = [np.asarray([255, 0, 0], np.uint8)] * len(pmasks)
        for pi, gi, _ in jexport.match_predictions_to_gt(pmasks, gmasks, 0.5):
            colors[pi] = gt_colors[gi]
        for k, panel in enumerate([jvis.overlay_instances(base, gmasks, gt_colors),
                                   jvis.overlay_instances(base, pmasks, colors)]):
            x0 = k * (32 + tvis.PANEL_GAP)
            np.testing.assert_array_equal(got[tvis.TITLE_H:, x0:x0 + 32], panel)
        assert (got[:tvis.TITLE_H] != 255).any()  # the titles
