"""The port's whole model and predictor against the JAX package, on the CPU.

The tiny 0.4.0 and 0.0.0 models (`ModelConfig.tiny`, 64x64 inputs) are
initialised by the JAX package; `from_flax` loads the same variables into the
port with `strict=True`. The depth channels are continuous random floats, so no
pixel sits on a DSAM window edge, where a last-bit difference in the depth
arithmetic could move it to the other side. Tolerance 1e-4 atol/rtol for the
logits: f32 reductions over ~30 stacked layers in another summation order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rgbdseg_tpu.config import ModelConfig as JConfig
from rgbdseg_tpu.inference.predictor import Predictor as JPredictor
from rgbdseg_tpu.models.mask2former import Mask2FormerRGBD as JModel
from rgbdseg_torch.config import ModelConfig
from rgbdseg_torch.inference.predictor import Predictor
from rgbdseg_torch.models.mask2former import Mask2FormerRGBD
from rgbdseg_torch.ops.kernels import LAUNCHES, reset_launches
from rgbdseg_torch.utils.weights import from_flax

MODEL_TOL = dict(atol=1e-4, rtol=1e-4)
HW = 64
CHANNELS = {"0.0.0": 3, "0.4.0": 10}


def _frames(version, seed=0, b=2):
    """A version's channel stack: normal RGB; for 0.4.0 continuous depth in
    [-2, 2], a gradient magnitude in [0, 1) and a 0/1 validity mask."""
    rng = np.random.RandomState(seed)
    x = rng.randn(b, HW, HW, CHANNELS[version]).astype(np.float32)
    if version == "0.4.0":
        x[..., 3:6] = rng.uniform(-2, 2, (b, HW, HW, 3))
        x[..., 6:9] = rng.rand(b, HW, HW, 3)
        x[..., 9] = rng.rand(b, HW, HW) > 0.3
    return x


@pytest.fixture(scope="module", params=sorted(CHANNELS))
def tiny(request):
    """(version, JAX config, variables as numpy, port model with them loaded).
    BatchNorm running stats are randomised, so the map of batch_stats matters."""
    version = request.param
    cfg = JConfig.tiny(num_labels=3, version=version)
    x = jnp.zeros((1, HW, HW, CHANNELS[version]), jnp.float32)
    v = jax.tree.map(np.asarray, jax.jit(JModel(cfg).init)({"params": jax.random.PRNGKey(1)}, x))
    v = {k: jax.tree.map(lambda a: a.copy(), v[k]) for k in v}
    rng = np.random.RandomState(11)
    for bn in v.get("batch_stats", {}).get("pixel_level_module", {}).get("ratio_predictor", {}).values():
        bn["mean"] = rng.normal(0, 0.1, bn["mean"].shape).astype(np.float32)
        bn["var"] = rng.uniform(0.5, 1.5, bn["var"].shape).astype(np.float32)
    model = Mask2FormerRGBD(ModelConfig.tiny(num_labels=3, version=version))
    model.load_state_dict(from_flax(v["params"], v.get("batch_stats")), strict=True)
    return version, cfg, v, model.eval()


def test_forward_final_and_aux_logits(tiny):
    version, cfg, v, model = tiny
    x = _frames(version)
    ref = jax.jit(lambda vv, xx: JModel(cfg).apply(vv, xx, deterministic=True))(v, jnp.asarray(x))
    with torch.no_grad():
        out = model(torch.from_numpy(x))
    assert out.masks_queries_logits.shape == (2, cfg.num_queries, HW // 4, HW // 4)
    assert len(out.aux_class_logits) == len(ref.aux_class_logits) == cfg.decoder_layers - 1
    pairs = [
        (out.class_queries_logits, ref.class_queries_logits),
        (out.masks_queries_logits, ref.masks_queries_logits),
        *zip(out.aux_class_logits, ref.aux_class_logits),
        *zip(out.aux_mask_logits, ref.aux_mask_logits),
    ]
    for o, r in pairs:
        np.testing.assert_allclose(o.numpy(), np.asarray(r), **MODEL_TOL)


@pytest.mark.parametrize("threshold", [0.0, 0.5])
def test_predict_pixels_matches_jax(tiny, threshold):
    """Same labels, scores to 1e-5, and >= 99.9% equal mask pixels: only a
    pixel whose resized logit sits at 0 may flip."""
    version, cfg, v, model = tiny
    x = _frames(version, seed=1)
    ref = JPredictor(cfg, v["params"], v.get("batch_stats")).predict_pixels(x, threshold=threshold)
    pred = Predictor(ModelConfig.tiny(num_labels=3, version=version), state_dict=model.state_dict(), device="cpu")
    reset_launches()
    out = pred.predict_pixels(x, threshold=threshold)
    assert LAUNCHES == {"deformable": 0, "masked_attention": 0}
    assert len(out) == len(ref) == 2
    for o, r in zip(out, ref):
        assert [s["label_id"] for s in o["segments_info"]] == [s["label_id"] for s in r["segments_info"]]
        np.testing.assert_allclose(
            [s["score"] for s in o["segments_info"]], [s["score"] for s in r["segments_info"]], atol=1e-5
        )
        assert o["segmentation"].shape == r["segmentation"].shape
        assert o["segmentation"].dtype == np.uint8
        assert o["segments_info"] or threshold > 0
        if o["segmentation"].size:
            assert (o["segmentation"] == r["segmentation"]).mean() >= 0.999
