"""The port's serve-from-frames and eval path against the JAX package, on the CPU.

The tiny 0.4.0 model (`ModelConfig.tiny`, 64x64) is initialised by the JAX
package and loaded into the port with `from_flax`, as in
`tests/test_torch_model.py`. Held here:
- `eval_stats` against `_eval_stats_device`: labels and the IoU counts exact,
  the scores to 1e-6 (float32 softmax and sigmoid in another implementation);
- the port's `MeanAveragePrecision` and `Evaluator` (device-stats and host
  paths) against the JAX package's, metric dicts equal;
- `Predictor.predict_example` from PNG files against the JAX package's: logits
  at the model tolerance of `tests/test_torch_model.py` (1e-4), segments equal
  in number and labels, scores to 1e-5, >= 99.9% equal mask pixels;
- `train.trainer.evaluate` over two batches (raw uint8 frames with packed
  masks; a float stack with plain masks): its metrics equal the JAX
  `Evaluator`'s on the port's own logits, and its loss the JAX eval step's
  (the model and `mask2former_loss`, the same points injected into both
  criteria as `tests/test_torch_train.py` does) to the model tolerance.
The channel builder on the card is held to the CPU, bitwise, by the `cuda`-marked
`tests/test_torch_kernels.py::test_cuda_channel_builder_equals_cpu_bitwise`
(that file imports without JAX, as the card's machine has none).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from rgbdseg_tpu.config import ModelConfig as JConfig
from rgbdseg_tpu.config import PreprocessConfig as JPreprocessConfig
from rgbdseg_tpu.data import device_preprocess as JDP
from rgbdseg_tpu.data.pipeline import Batch as JBatch
from rgbdseg_tpu.inference.postprocess import _eval_stats_device
from rgbdseg_tpu.inference.predictor import Predictor as JPredictor
from rgbdseg_tpu.models.mask2former import Mask2FormerRGBD as JModel
from rgbdseg_tpu.ops import losses as jlosses
from rgbdseg_tpu.train.evaluator import Evaluator as JEvaluator
from rgbdseg_tpu.train.map_metric import MeanAveragePrecision as JMAP
from rgbdseg_torch.config import ModelConfig, PreprocessConfig
from rgbdseg_torch.data import registry as TR
from rgbdseg_torch.data.device_preprocess import build_pixels
from rgbdseg_torch.data.pipeline import Batch
from rgbdseg_torch.inference.postprocess import eval_stats
from rgbdseg_torch.inference.predictor import Predictor
from rgbdseg_torch.models.mask2former import Mask2FormerRGBD
from rgbdseg_torch.ops import losses as tlosses
from rgbdseg_torch.ops.kernels import LAUNCHES, reset_launches
from rgbdseg_torch.train.evaluator import Evaluator
from rgbdseg_torch.train.map_metric import MeanAveragePrecision
from rgbdseg_torch.train.trainer import evaluate
from rgbdseg_torch.utils.weights import from_flax

MODEL_TOL = dict(atol=1e-4, rtol=1e-4)
HW = 64
NUM_LABELS = 3
ID2LABEL = {0: "background", 1: "box", 2: "ball"}


@pytest.fixture(scope="module")
def tiny():
    """(JAX config, JAX variables, the port's model with them loaded, eval mode)."""
    cfg = JConfig.tiny(num_labels=NUM_LABELS, version="0.4.0")
    v = jax.jit(JModel(cfg).init)({"params": jax.random.PRNGKey(1)}, jnp.zeros((1, HW, HW, 10), jnp.float32))
    v = jax.tree.map(lambda a: np.asarray(a).copy(), v)
    model = Mask2FormerRGBD(ModelConfig.tiny(num_labels=NUM_LABELS, version="0.4.0"))
    model.load_state_dict(from_flax(v["params"], v.get("batch_stats")), strict=True)
    return cfg, v, model.eval()


def _gt(rng, b, t, gh, gw, empty_first=False):
    masks = np.zeros((b, t, gh, gw), np.float32)
    valid = np.zeros((b, t), bool)
    for i in range(b):
        for j in range(0 if (empty_first and i == 0) else rng.randint(1, t + 1)):
            y0, x0 = rng.randint(0, gh // 2), rng.randint(0, gw // 2)
            masks[i, j, y0 : y0 + rng.randint(4, gh // 2), x0 : x0 + rng.randint(4, gw // 2)] = 1.0
            valid[i, j] = True
    return masks, rng.randint(0, 5, (b, t)).astype(np.int32), valid


@pytest.mark.parametrize("gt_hw,target_hw", [((48, 64), (48, 64)), ((48, 64), (96, 120)), ((45, 67), (30, 41))])
def test_eval_stats_match_jax(gt_hw, target_hw):
    rng = np.random.RandomState(0)
    b, t, q = 2, 6, 12
    cl = (rng.randn(b, q, 6) * 2).astype(np.float32)
    ml = rng.randn(b, q, gt_hw[0] // 4, gt_hw[1] // 4).astype(np.float32)
    masks, _, valid = _gt(rng, b, t, *gt_hw, empty_first=True)
    packed = np.packbits(masks.astype(bool).reshape(b, t, -1), axis=-1)
    ref = [np.asarray(a) for a in _eval_stats_device(*(jnp.asarray(a) for a in (cl, ml, packed, valid)),
                                                          target_hw, gt_hw)]
    got = [a.numpy() for a in eval_stats(*(torch.from_numpy(a) for a in (cl, ml, packed, valid)), target_hw, gt_hw)]
    np.testing.assert_allclose(got[0], ref[0], rtol=1e-6, atol=0)
    for g, r in zip(got[1:], ref[1:]):
        assert g.shape == r.shape
        np.testing.assert_array_equal(g, r)
    assert got[4].max() > 0


def test_mean_average_precision_equals_jax_copy():
    rng = np.random.RandomState(1)
    ours, theirs = MeanAveragePrecision(), JMAP()
    for _ in range(3):
        n, m, h, w = 7, 5, 33, 41
        preds = [{"scores": np.round(rng.rand(n), 6), "labels": rng.randint(0, 3, n), "masks": rng.rand(n, h, w) > 0.6}]
        targets = [{"labels": rng.randint(0, 3, m), "masks": rng.rand(m, h, w) > 0.6}]
        for metric in (ours, theirs):
            metric.update(preds, targets)
            p, g = preds[0], targets[0]
            inter = p["masks"].reshape(n, -1).astype(np.float64) @ g["masks"].reshape(m, -1).T.astype(np.float64)
            metric.update_precomputed(p["scores"], p["labels"], p["masks"].sum((1, 2)), inter, g["labels"],
                                      g["masks"].sum((1, 2)))
    a, b = ours.compute(), theirs.compute()
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=k)


@pytest.mark.parametrize("device_stats", ["1", "0"], ids=["device_stats", "host_masks"])
@pytest.mark.parametrize("gh,gw,orig,threshold", [(48, 64, None, 0.0), (48, 64, (96, 120), 0.0),
                                                  (45, 67, None, 0.0), (48, 64, None, 0.5)])
def test_evaluator_matches_jax(monkeypatch, device_stats, gh, gw, orig, threshold):
    monkeypatch.setenv("RGBDSEG_EVAL_DEVICE_STATS", device_stats)
    rng = np.random.RandomState(0)
    b, t, q = 2, 6, 12
    ours = Evaluator(ID2LABEL, threshold=threshold, eval_at_original_size=orig is not None)
    theirs = JEvaluator(ID2LABEL, threshold=threshold, eval_at_original_size=orig is not None)
    for k in range(3):
        masks, classes, valid = _gt(rng, b, t, gh, gw, empty_first=k == 0)
        fields = dict(pixel_values=np.zeros((b, gh, gw, 3), np.float32), mask_labels=masks, class_labels=classes,
                      valid=valid, orig_sizes=None if orig is None else np.tile([list(orig)], (b, 1)).astype(np.int32))
        cl = (rng.randn(b, q, 6) * 2).astype(np.float32)
        ml = rng.randn(b, q, gh // 4, gw // 4).astype(np.float32)
        ours.update(torch.from_numpy(cl), torch.from_numpy(ml), Batch(**fields))
        theirs.update(cl, ml, JBatch(**fields))
    a, r = ours.compute(prefix="eval_"), theirs.compute(prefix="eval_")
    assert a == r


def _frames(rng, h, w):
    """A uint8 RGB frame and an 8-bit depth plane with a nearer box and holes."""
    rgb = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
    yy, xx = np.mgrid[0:h, 0:w]
    depth = 150 + 0.3 * yy - 0.2 * xx
    depth[h // 4 : h // 2, w // 3 : 2 * w // 3] = 70
    depth = np.clip(np.round(depth), 0, 255).astype(np.uint8)
    depth[rng.rand(h, w) < 0.02] = 0
    return rgb, depth


def test_predict_example_from_png_files_matches_jax(tiny, tmp_path):
    """100x150 frames on disk (RGB, and gray depth as cameras save it), served
    at 64x64: both packages resize and build the channels from the raw frames."""
    cfg, v, model = tiny
    rgb, depth = _frames(np.random.RandomState(4), 100, 150)
    paths = [str(tmp_path / "rgb.png"), str(tmp_path / "depth.png")]
    Image.fromarray(rgb).save(paths[0])
    Image.fromarray(depth).save(paths[1])
    example = {"image": paths}
    jp = JPredictor(cfg, v["params"], v.get("batch_stats"), preprocess=JPreprocessConfig(height=HW, width=HW))
    pred = Predictor(ModelConfig.tiny(num_labels=NUM_LABELS, version="0.4.0"), state_dict=model.state_dict(),
                     device="cpu", preprocess=PreprocessConfig(height=HW, width=HW))
    ref = jp.predict_example(example, threshold=0.0)
    assert jp._apply_raw is not None  # the JAX package built the channels from the raw frames too
    reset_launches()
    out = pred.predict_example(example, threshold=0.0)
    assert set(LAUNCHES.values()) == {0}
    assert pred.last_upload_bytes == 100 * 150 * 6

    frames = [rgb, np.repeat(depth[..., None], 3, -1)]
    j_logits = jp._apply_raw(jnp.asarray(np.concatenate(frames, -1))[None])
    t_logits = pred._forward_raw(frames)
    for o, r in zip(t_logits, j_logits):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), **MODEL_TOL)

    assert out["segments_info"]
    assert [s["label_id"] for s in out["segments_info"]] == [s["label_id"] for s in ref["segments_info"]]
    np.testing.assert_allclose([s["score"] for s in out["segments_info"]],
                               [s["score"] for s in ref["segments_info"]], atol=1e-5)
    assert out["segmentation"].shape == ref["segmentation"].shape == (len(out["segments_info"]), HW, HW)
    assert (out["segmentation"] == ref["segmentation"]).mean() >= 0.999


def _coords(shape):
    """The same uniform coordinates for a given shape on both sides."""
    rng = np.random.RandomState(abs(hash(tuple(shape))) % (2**31))
    return rng.uniform(0.0, 1.0, shape).astype(np.float32)


def _eval_batches(rng, t=6):
    """Two batches of 2 examples at 64x64: raw packed uint8 frames with packed
    masks, then the CPU-built float stack with plain masks. Instances come from
    an instance map through the registry's mask path."""
    pp = PreprocessConfig(height=HW, width=HW)
    batches = []
    for kind in ("raw", "float"):
        frames, masks, classes, valid = [], np.zeros((2, t, HW, HW), np.float32), np.zeros((2, t), np.int32), \
            np.zeros((2, t), bool)
        for i in range(2):
            rgb, depth = _frames(rng, HW, HW)
            ann = np.zeros((HW, HW, 3), np.uint8)
            for j in range(1, rng.randint(2, t)):
                y0, x0 = rng.randint(0, HW - 16, 2)
                ann[y0 : y0 + rng.randint(8, 32), x0 : x0 + rng.randint(8, 32), 1:] = (j, rng.randint(0, NUM_LABELS))
            ann[..., 2] = np.where(ann[..., 1] == 0, 0, ann[..., 2])
            m, c = TR._labels(*TR._mask_and_mapping(ann), pp)
            masks[i, : len(m)], classes[i, : len(c)], valid[i, : len(m)] = m, c, True
            frames.append(np.concatenate([rgb, np.repeat(depth[..., None], 3, -1)], -1))
        packed = np.stack(frames)
        if kind == "raw":
            batches.append(Batch(packed, masks, classes, valid,
                                 mask_labels_packed=np.packbits(masks.astype(bool).reshape(2, t, -1), axis=-1)))
        else:
            pix = build_pixels("map_10channel_case2", torch.from_numpy(packed[..., :3]),
                               torch.from_numpy(packed[..., 3:]), pp).numpy()
            batches.append(Batch(pix, masks, classes, valid))
    return batches


def test_evaluate_matches_jax_evaluator_and_loss(tiny, monkeypatch):
    cfg, v, model = tiny
    monkeypatch.setattr(jlosses, "_uniform", lambda rng, shape: jnp.asarray(_coords(shape)))
    monkeypatch.setattr(tlosses, "_uniform", lambda generator, shape: torch.from_numpy(_coords(shape)))
    batches = _eval_batches(np.random.RandomState(6))
    pp = PreprocessConfig(height=HW, width=HW)
    reset_launches()
    got = evaluate(model, batches, ID2LABEL, pp, generator=torch.Generator().manual_seed(0))
    assert set(LAUNCHES.values()) == {0}

    jev = JEvaluator(ID2LABEL, threshold=0.0)
    apply = jax.jit(lambda vv, x: JModel(cfg).apply(vv, x, deterministic=True))
    jloss = jax.jit(lambda out, m, c, vd: jlosses.mask2former_loss(cfg, out, m, c, vd, jax.random.PRNGKey(0))[0])
    losses = []
    for batch in batches:
        pix = batch.pixel_values
        if pix.dtype == np.uint8:
            pix = JDP.build_from_packed("map_10channel_case2", jnp.asarray(pix),
                                        JPreprocessConfig(height=HW, width=HW))
        with torch.no_grad():
            out = model(torch.as_tensor(np.asarray(pix)))
        jev.update(out.class_queries_logits.numpy(), out.masks_queries_logits.numpy(),
                   JBatch(batch.pixel_values, batch.mask_labels, batch.class_labels, batch.valid))
        losses.append(float(jloss(apply(v, jnp.asarray(pix)), *(jnp.asarray(a) for a in (
            batch.mask_labels, batch.class_labels, batch.valid)))))
    want = jev.compute(prefix="eval_")
    assert {k: got[k] for k in want} == want
    assert set(got) == set(want) | {"eval_loss", "eval_runtime", "eval_samples_per_second"}
    assert want["eval_map"] >= 0
    np.testing.assert_allclose(got["eval_loss"], np.mean(losses), **MODEL_TOL)


def test_predict_example_rgb_only_uploads_rgb_and_equals_predict_pixels():
    """0.0.0 (map_3channel): one 3-byte-per-pixel upload of a uint8 array, and
    the same instances as `predict_pixels` on the registry's stack of it."""
    pp = PreprocessConfig(height=HW, width=HW)
    pred = Predictor(ModelConfig.tiny(num_labels=NUM_LABELS, version="0.0.0"), device="cpu", preprocess=pp)
    rgb = np.random.RandomState(2).randint(0, 256, (80, 100, 3)).astype(np.uint8)
    out = pred.predict_example({"image": rgb}, threshold=0.0)
    assert pred.last_upload_bytes == 80 * 100 * 3
    ref = pred.predict_pixels(TR.map_3channel({"image": rgb}, pp)[0][None], threshold=0.0)[0]
    assert out["segments_info"] == ref["segments_info"]
    np.testing.assert_array_equal(out["segmentation"], ref["segmentation"])


def test_predict_example_applies_transform_before_packing(tiny):
    """A set `registry.TRANSFORM` acts on the numpy colour frame before the
    upload: flipping it there serves what the flipped frame serves."""
    _, _, model = tiny
    pred = Predictor(ModelConfig.tiny(num_labels=NUM_LABELS, version="0.4.0"), state_dict=model.state_dict(),
                     device="cpu", preprocess=PreprocessConfig(height=HW, width=HW))
    rgb, depth = _frames(np.random.RandomState(5), 70, 90)
    TR.set_transform(lambda image, mask: {"image": image[:, ::-1].copy(), "mask": mask[:, ::-1].copy()})
    try:
        got = pred.predict_example({"image": [rgb, depth]}, threshold=0.0)
    finally:
        TR.set_transform(None)
    want = pred.predict_example({"image": [rgb[:, ::-1].copy(), depth]}, threshold=0.0)
    assert got["segments_info"] == want["segments_info"]
    np.testing.assert_array_equal(got["segmentation"], want["segmentation"])
