"""Each ported module against its JAX counterpart, on the CPU at tiny size.

Inputs come from seeded numpy and go to both packages; the JAX variables come
from initialising the tiny model (`ModelConfig.tiny`) and reach the port through
`from_flax`. Tolerances: 1e-5 for single ops (the same f32 arithmetic in
another order), 1e-4 atol/rtol for whole modules (f32 reductions over many
layers, conv algorithms that sum in another order, BN folded into the conv on
the JAX side), and bitwise for the depth decomposition.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rgbdseg_tpu.config import ModelConfig as JConfig
from rgbdseg_tpu.inference import postprocess as jpost
from rgbdseg_tpu.models import fusion as jfusion
from rgbdseg_tpu.models.mask2former import Mask2FormerRGBD as JModel
from rgbdseg_tpu.models.pixel_decoder import PixelDecoder as JPixelDecoder
from rgbdseg_tpu.models.position import sine_position_embedding as j_sine
from rgbdseg_tpu.models.swin import SwinBackbone as JSwin
from rgbdseg_tpu.models.transformer_decoder import TransformerModule as JTransformer
from rgbdseg_tpu.ops import depth_decomp as JD
from rgbdseg_tpu.ops import resize as jresize
from rgbdseg_tpu import versions as JV
from rgbdseg_torch import versions as TV
from rgbdseg_torch.config import ModelConfig
from rgbdseg_torch.inference import postprocess as tpost
from rgbdseg_torch.models import fusion as tfusion
from rgbdseg_torch.models.pixel_decoder import PixelDecoder
from rgbdseg_torch.models.position import sine_position_embedding
from rgbdseg_torch.models.swin import SwinBackbone
from rgbdseg_torch.models.transformer_decoder import TransformerModule
from rgbdseg_torch.ops import depth_decomp as TD
from rgbdseg_torch.ops import resize as tresize
from rgbdseg_torch.utils.weights import from_flax

OP_TOL = dict(atol=1e-5, rtol=1e-5)
MODULE_TOL = dict(atol=1e-4, rtol=1e-4)
HW = 64


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(out, ref, tol):
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), **tol)


@pytest.fixture(scope="module")
def tiny():
    """Variables of the tiny 0.4.0 model, with randomised BN running stats."""
    cfg = JConfig.tiny(num_labels=3, version="0.4.0")
    x = jnp.zeros((1, HW, HW, 10), jnp.float32)
    v = jax.tree.map(np.asarray, jax.jit(JModel(cfg).init)({"params": jax.random.PRNGKey(0)}, x))
    rng = np.random.RandomState(7)
    stats = jax.tree.map(lambda a: a, v["batch_stats"])
    for bn in stats["pixel_level_module"]["ratio_predictor"].values():
        bn["mean"] = rng.normal(0, 0.1, bn["mean"].shape).astype(np.float32)
        bn["var"] = rng.uniform(0.5, 1.5, bn["var"].shape).astype(np.float32)
    return cfg, v["params"], stats


def _load(module, params, stats=None):
    module.load_state_dict(from_flax(params, stats), strict=True)
    return module.eval()


def _maps(cfg, seed=0, b=2):
    """Random channels-last backbone-shaped maps for a HW x HW input."""
    rng = np.random.RandomState(seed)
    ch = cfg.backbone.feature_channels
    return [rng.randn(b, HW // s, HW // s, c).astype(np.float32) for s, c in zip((4, 8, 16, 32), ch)]


@pytest.mark.parametrize("version", sorted(JV.REGISTRY))
def test_config_and_version_copies_match(version):
    """The port's copies of the config and the version registry say what the JAX package's say."""
    assert dataclasses.asdict(TV.get(version)) == dataclasses.asdict(JV.get(version))
    for make in ("tiny", None):
        jc = JConfig.tiny(num_labels=5, version=version) if make else JConfig(num_labels=5, version=version)
        tc = ModelConfig.tiny(num_labels=5, version=version) if make else ModelConfig(num_labels=5, version=version)
        assert tc.to_json() == jc.to_json()
        assert ModelConfig.from_json(jc.to_json()) == tc


@pytest.mark.parametrize("src,dst", [((17, 23), (40, 31)), ((64, 64), (16, 16)), ((15, 20), (384, 384))])
def test_resize_bilinear_and_nearest(src, dst):
    x = np.random.RandomState(0).randn(2, *src, 3).astype(np.float32)
    _close(tresize.resize_bilinear(_t(x), dst), jresize.resize_bilinear(jnp.asarray(x), dst), OP_TOL)
    np.testing.assert_array_equal(
        tresize.resize_nearest(_t(x), dst).numpy(), np.asarray(jresize.resize_nearest(jnp.asarray(x), dst))
    )


@pytest.mark.parametrize("src,dst", [((24, 32), (6, 8)), ((17, 23), (4, 4)), ((480 // 4, 640 // 4), (4, 4))])
def test_adaptive_pools(src, dst):
    x = np.random.RandomState(1).randn(2, *src, 5).astype(np.float32)
    np.testing.assert_array_equal(
        tresize.adaptive_max_pool2d(_t(x), dst).numpy(),
        np.asarray(jresize.adaptive_max_pool2d(jnp.asarray(x), dst)),
    )
    _close(tresize.adaptive_avg_pool2d(_t(x), dst), jresize.adaptive_avg_pool2d(jnp.asarray(x), dst), OP_TOL)


@pytest.mark.parametrize("h,w,f", [(15, 20, 128), (2, 2, 32), (60, 80, 16)])
def test_sine_position_embedding(h, w, f):
    _close(sine_position_embedding(h, w, f), j_sine(h, w, f), OP_TOL)


def test_swin_backbone(tiny):
    cfg, params, _ = tiny
    x = np.random.RandomState(2).randn(2, HW, 48, 3).astype(np.float32)  # 48: padded to the window
    ref = JSwin(cfg.backbone).apply({"params": params["pixel_level_module"]["encoder"]}, jnp.asarray(x))
    mod = _load(SwinBackbone(ModelConfig.tiny().backbone), params["pixel_level_module"]["encoder"])
    with torch.no_grad():
        out = mod(_t(x))
    assert len(out) == 4
    for o, r in zip(out, ref):
        _close(o, r, MODULE_TOL)


def test_edsam_ratio_predictor(tiny):
    _, params, stats = tiny
    depth = np.random.RandomState(3).randn(2, HW, HW, 3).astype(np.float32)
    variables = {
        "params": params["pixel_level_module"]["ratio_predictor"],
        "batch_stats": stats["pixel_level_module"]["ratio_predictor"],
    }
    ref = jfusion.EnhancedDepthImageRatioPredictor().apply(variables, jnp.asarray(depth))
    mod = _load(tfusion.EnhancedDepthImageRatioPredictor(), variables["params"], variables["batch_stats"])
    with torch.no_grad():
        _close(mod(_t(depth)), ref, MODULE_TOL)


def test_dsam_cascade_fixed_ratio(tiny):
    """Continuous random depth, so no pixel sits on a window edge."""
    cfg, params, _ = tiny
    maps = _maps(cfg, seed=4)
    depth3 = np.random.RandomState(5).uniform(-2, 2, (2, HW, HW, 3)).astype(np.float32)
    ratio = np.array([0.1, 0.35], np.float32)
    p = params["pixel_level_module"]["dsam_cascade"]
    jmod = jfusion.DSAMCascade(channels=cfg.backbone.feature_channels, hist_bins=cfg.dsam_hist_bins)
    ref = jmod.apply({"params": p}, [jnp.asarray(m) for m in maps], jnp.asarray(depth3), jnp.asarray(ratio))
    mod = _load(tfusion.DSAMCascade(cfg.backbone.feature_channels, hist_bins=cfg.dsam_hist_bins), p)
    with torch.no_grad():
        out = mod([_t(m) for m in maps], _t(depth3), _t(ratio))
    for o, r in zip(out, ref):
        _close(o, r, MODULE_TOL)


def test_dggm_residual(tiny):
    cfg, params, _ = tiny
    maps = _maps(cfg, seed=6)
    rng = np.random.RandomState(7)
    grad = rng.rand(2, HW, HW, 3).astype(np.float32)
    mask = (rng.rand(2, HW, HW, 1) > 0.3).astype(np.float32)
    p = params["pixel_level_module"]["dggm"]
    ref = jfusion.DepthGradientInjectionResidual().apply(
        {"params": p}, [jnp.asarray(m) for m in maps], jnp.asarray(grad), jnp.asarray(mask)
    )
    mod = _load(tfusion.DepthGradientInjectionResidual(cfg.backbone.feature_channels), p)
    with torch.no_grad():
        out = mod([_t(m) for m in maps], _t(grad), _t(mask))
    for o, r in zip(out, ref):
        _close(o, r, OP_TOL)


def test_pixel_decoder(tiny):
    cfg, params, _ = tiny
    maps = _maps(cfg, seed=8)
    p = params["pixel_level_module"]["pixel_decoder"]
    ref_mf, ref_ms = JPixelDecoder(cfg).apply({"params": p}, [jnp.asarray(m) for m in maps])
    mod = _load(PixelDecoder(ModelConfig.tiny(), cfg.backbone.feature_channels), p)
    with torch.no_grad():
        mf, ms = mod([_t(m) for m in maps])
    _close(mf, ref_mf, MODULE_TOL)
    for o, r in zip(ms, ref_ms):
        _close(o, r, MODULE_TOL)


def test_transformer_decoder(tiny):
    cfg, params, _ = tiny
    rng = np.random.RandomState(9)
    d = cfg.hidden_dim
    ms = [rng.randn(2, s, s, d).astype(np.float32) for s in (2, 4, 8)]
    mf = rng.randn(2, HW // 4, HW // 4, cfg.mask_feature_size).astype(np.float32)
    p = params["transformer_module"]
    ref_cls, ref_mask = JTransformer(cfg).apply({"params": p}, [jnp.asarray(m) for m in ms], jnp.asarray(mf))
    mod = _load(TransformerModule(ModelConfig.tiny(num_labels=3)), p)
    with torch.no_grad():
        cls, mask = mod([_t(m) for m in ms], _t(mf))
    assert len(cls) == len(ref_cls) == cfg.decoder_layers
    for o, r in zip(cls + mask, list(ref_cls) + list(ref_mask)):
        _close(o, r, MODULE_TOL)


def test_post_process_instance_segmentation():
    """Same labels, scores to 1e-5, and >= 99.9% equal mask pixels (a pixel
    whose resized logit sits at 0 may flip)."""
    rng = np.random.RandomState(10)
    cls = rng.randn(2, 10, 4).astype(np.float32) * 3
    mask = rng.randn(2, 10, 16, 16).astype(np.float32) * 4
    for thr, binary in ((0.0, True), (0.3, True), (0.0, False)):
        kw = dict(threshold=thr, target_sizes=[(64, 64), (40, 50)], return_binary_maps=binary)
        ref = jpost.post_process_instance_segmentation(cls, mask, **kw)
        out = tpost.post_process_instance_segmentation(_t(cls), _t(mask), **kw)
        for o, r in zip(out, ref):
            assert [s["label_id"] for s in o["segments_info"]] == [s["label_id"] for s in r["segments_info"]]
            np.testing.assert_allclose([s["score"] for s in o["segments_info"]],
                                       [s["score"] for s in r["segments_info"]], atol=1e-5)
            assert o["segmentation"].shape == r["segmentation"].shape
            assert (o["segmentation"] == r["segmentation"]).mean() >= 0.999


# --- depth decomposition: bitwise against the golden cases of tests/test_ops_depth.py ---


def _multimodal(seed):
    rng = np.random.RandomState(seed)
    d = np.concatenate(
        [rng.normal(10, 1, 400), rng.normal(30, 2, 500), rng.normal(60, 1.5, 300), rng.uniform(0, 80, 336)]
    ).astype(np.float32)
    rng.shuffle(d)
    d = d.reshape(32, 48)
    d[0, :5] = np.nan
    return d[None], np.array([0.1], np.float32)


def _two_valued():
    two = np.full((8, 8), 5.0, np.float32)
    two[::2] = 40.0
    return two[None], np.array([0.1], np.float32)


_FULL_CASES = {
    **{f"multimodal_nan_seed{s}": (lambda s=s: _multimodal(s)) for s in range(4)},
    "constant_8x8": lambda: (np.full((1, 8, 8), 5.0, np.float32), np.array([0.1], np.float32)),
    "two_valued_8x8": _two_valued,
}


@pytest.mark.parametrize("case", sorted(_FULL_CASES))
def test_dsam_region_masks_bitwise(case):
    depth, ratio = _FULL_CASES[case]()
    rm, ra = JD.dsam_region_masks(jnp.asarray(depth), jnp.asarray(ratio))
    tm, ta = TD.dsam_region_masks(_t(depth), _t(ratio))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(rm))
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ra))


def _pooled_case(seed):
    rng = np.random.RandomState(seed)
    d = np.concatenate([rng.normal(10, 1, 500), rng.normal(40, 2, 600), rng.uniform(0, 80, 436)]).astype(np.float32)
    rng.shuffle(d)
    d = d.reshape(2, 24, 32)
    d[0, 0, :7] = np.nan
    return d, np.array([0.1, 0.35], np.float32), (6, 8)


_POOLED_CASES = {
    **{f"nan_two_ratios_seed{s}": (lambda s=s: _pooled_case(s)) for s in range(3)},
    "constant_16x16": lambda: (np.full((1, 16, 16), 5.0, np.float32), np.array([0.2], np.float32), (4, 4)),
}


@pytest.mark.parametrize("case", sorted(_POOLED_CASES))
def test_dsam_region_masks_pooled_bitwise(case):
    depth, ratio, size = _POOLED_CASES[case]()
    rm, ra = JD.dsam_region_masks_pooled(jnp.asarray(depth), jnp.asarray(ratio), size)
    tm, ta = TD.dsam_region_masks_pooled(_t(depth), _t(ratio), size)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(rm))
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ra))
    # the full-resolution masks max-pooled equal the fused compare+pool
    full, _ = TD.dsam_region_masks(_t(depth), _t(ratio))
    np.testing.assert_array_equal(tresize.adaptive_max_pool2d(full.permute(0, 2, 3, 1), size).numpy(), tm.numpy())


@pytest.mark.parametrize("seed", range(3))
def test_histogram_peaks_and_modes_bitwise(seed):
    """Integer-valued histograms exercise plateaus; a seeded depth map exercises
    the histogram and the (height desc, center desc) ordering."""
    hist = np.random.RandomState(seed).poisson(5, size=(1, 512)).astype(np.float32)
    jp = JD.local_maxima(jnp.asarray(hist[0]))[0]
    tp = TD.local_maxima(_t(hist))
    np.testing.assert_array_equal(tp[0].numpy(), np.asarray(jp))
    np.testing.assert_array_equal(
        TD.peak_prominences(_t(hist), tp)[0].numpy(), np.asarray(JD.peak_prominences(jnp.asarray(hist[0]), jp))
    )
    depth, _ = _multimodal(seed)
    jh, jlo, jw = JD.depth_histogram(jnp.asarray(depth[0]), 512)
    th, tlo, tw = TD.depth_histogram(_t(depth), 512)
    np.testing.assert_array_equal(th[0].numpy(), np.asarray(jh))
    assert tlo.item() == float(jlo) and tw.item() == float(jw)
    jc, jv = JD.select_modes(jh, jlo, jw, 3, 0.01)
    tc, tv = TD.select_modes(th, tlo, tw, 3, 0.01)
    np.testing.assert_array_equal(tc[0].numpy(), np.asarray(jc))
    np.testing.assert_array_equal(tv[0].numpy(), np.asarray(jv))
