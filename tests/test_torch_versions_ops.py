"""The ops, channel builders and fusion modules of the ablation versions, port
against the JAX package, on the CPU.

- surface normals (`ops/normals.py`), both methods, invalid pixels included:
  atol 1e-5; the host `calculate_surface_normals` (numpy, `ops/sobel.py` for
  cv2's Sobel) against the JAX package's cv2 one;
- CSF (`ops/csf.py`) on uint8 frames: the similarities, sources, round images,
  counts, scores, weights and the float32 fused image equal bit for bit, so the
  uint8 truncation of `csf_fuse` is equal too; ties (equal frames) resolved to
  the first maximum;
- every map function of the registry and every layout of the device builder
  against the JAX package's, at the target size and from two other sizes: bit
  for bit;
- the eight fusion modules the 0.4.0 path lacks, in train and eval mode, at
  MODULE_TOL (1e-4; the JAX eval path folds BatchNorm into the convolution and
  runs low-channel convolutions as im2col products).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from rgbdseg_tpu.config import PreprocessConfig as JPreprocess
from rgbdseg_tpu.data import device_preprocess as JDP
from rgbdseg_tpu.data import registry as JR
from rgbdseg_tpu.data.depth_features import calculate_surface_normals as j_surface_normals
from rgbdseg_tpu.models import fusion as jfusion
from rgbdseg_tpu.ops import csf as jcsf
from rgbdseg_tpu.ops import normals as jnormals
from rgbdseg_torch.config import PreprocessConfig
from rgbdseg_torch.data import device_preprocess as TDP
from rgbdseg_torch.data import registry as TR
from rgbdseg_torch.data.depth_features import calculate_surface_normals
from rgbdseg_torch.models import fusion as tfusion
from rgbdseg_torch.ops import csf as tcsf
from rgbdseg_torch.ops import normals as tnormals
from rgbdseg_torch.utils.weights import from_flax

OP_TOL = dict(atol=1e-5, rtol=1e-5)
MODULE_TOL = dict(atol=1e-4, rtol=1e-4)
CHANNELS = (32, 64, 128, 256)  # the tiny Swin's pyramid


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _depth(rng, b=2, h=24, w=32, holes=True):
    d = rng.randint(0, 256, (b, h, w)).astype(np.float32)
    if holes:
        d[:, 3:6, 4:9] = 0
        d[0, 10, 10] = np.nan
    return d


# ---------------------------------------------------------------- normals


def test_surface_normals_gradient_matches_jax():
    d = _depth(np.random.RandomState(0))
    ref_n, ref_v = jax.vmap(jnormals.surface_normals_gradient)(jnp.asarray(d))
    n, v = tnormals.surface_normals_gradient(_t(d))
    np.testing.assert_allclose(n.numpy(), np.asarray(ref_n), **OP_TOL)
    np.testing.assert_array_equal(v.numpy(), np.asarray(ref_v))
    assert v.dtype == torch.float32 and 0 < v.sum() < v.numel()


def test_surface_normals_intrinsics_matches_jax():
    rng = np.random.RandomState(1)
    d = rng.uniform(0.5, 5, (2, 24, 32)).astype(np.float32)
    d[:, 3:6, 4:9] = 0
    d[1, 10, 10] = np.nan
    fx, fy, cx, cy = (np.array(p, np.float32) for p in ([300.0, 2.5], [310.0, 400.0], [16.0, 3.5], [12.0, 20.0]))
    ref_n, ref_v = jax.vmap(jnormals.surface_normals_intrinsics)(*map(jnp.asarray, (d, fx, fy, cx, cy)))
    n, v = tnormals.surface_normals_intrinsics(*map(_t, (d, fx, fy, cx, cy)))
    np.testing.assert_allclose(n.numpy(), np.asarray(ref_n), **OP_TOL)
    np.testing.assert_array_equal(v.numpy(), np.asarray(ref_v))
    assert not torch.isnan(n).any()
    # an invalid pixel turns its neighbours' differences invalid: more zeros than holes
    assert (v == 0).sum() > (~((d != 0) & ~np.isnan(d))).sum()


@pytest.mark.parametrize("intrinsics", [None, {"fx": 300.0, "fy": 310.0, "cx": 16.0, "cy": 12.0}])
def test_host_surface_normals_match_jax(intrinsics):
    rng = np.random.RandomState(2)
    d = _depth(rng, b=1)[0]
    if intrinsics:
        d = d / 50.0
    ref = j_surface_normals(d, intrinsics)
    got = calculate_surface_normals(d, intrinsics)
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype
        np.testing.assert_array_equal(g, r)


# ---------------------------------------------------------------- CSF


@pytest.mark.parametrize("kind", ["random", "tied"])
def test_csf_matches_jax_bitwise(kind):
    """Every intermediate equal; the fused float32 image equal, so its uint8
    truncation is. "tied": equal frames, so every similarity ties and the
    first maximum (the reference's strict `>` scan) decides."""
    rng = np.random.RandomState(3)
    imgs = rng.randint(0, 256, (8, 30, 40, 3)).astype(np.uint8)
    imgs[:, :2] = 0  # both-zero pixels: similarity 1
    imgs[3] = imgs[5]
    if kind == "tied":
        imgs[:] = imgs[0]
    ref = jcsf.csf_intermediates(jnp.asarray(imgs))
    got = tcsf.csf_intermediates(_t(imgs))
    for k in ref:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]), err_msg=k)
    if kind == "tied":
        assert set(np.unique(got["best"].numpy())) == {0, 1}  # round 0 takes frame 1, the others frame 0
    fused = tcsf.csf_fuse(_t(imgs))
    assert fused.dtype == torch.uint8
    np.testing.assert_array_equal(fused.numpy(), np.asarray(jcsf.csf_fuse(jnp.asarray(imgs))))
    assert torch.equal(tcsf.csf_fuse(_t(imgs[:1])), _t(imgs[0]))


# ---------------------------------------------------------------- channel builders


@pytest.fixture(scope="module")
def frame_files(tmp_path_factory):
    """10 random frames and an annotation at each of three sizes, as PNG files
    (frame 1 is a blocky gray depth: flat regions and edges)."""
    from PIL import Image

    root = tmp_path_factory.mktemp("frames")
    rng = np.random.RandomState(4)
    out = {}
    for size in [(64, 96), (100, 150), (40, 60)]:
        paths = []
        for i in range(10):
            f = rng.randint(0, 256, (*size, 3), dtype=np.uint8)
            if i == 1:
                f = np.repeat((rng.randint(0, 8, size) * 30).astype(np.uint8)[..., None], 3, -1)
            paths.append(str(root / f"{size[0]}_{i}.png"))
            Image.fromarray(f).save(paths[-1])
        mask = np.zeros((*size, 3), np.uint8)
        mask[5:20, 5:30, 1:] = (1, 2)
        mask[22:30, 10:40, 1:] = (2, 1)
        mp = str(root / f"{size[0]}_mask.png")
        Image.fromarray(mask).save(mp)
        out[size] = (paths, mp)
    return out


@pytest.mark.parametrize("size", [(64, 96), (100, 150), (40, 60)], ids=["target", "larger", "smaller"])
@pytest.mark.parametrize("map_fn", sorted(JR.MAP_FUNCTIONS))
def test_map_functions_match_jax_bitwise(frame_files, map_fn, size):
    """pixels, masks and labels of each map function, and for the layouts the
    device builder builds, its stack from the packed frames: equal to the JAX
    package's bit for bit."""
    paths, mask = frame_files[size]
    example = {"image": paths if map_fn == "map_30channel" else paths[:3], "annotation": mask}
    ref = JR.MAP_FUNCTIONS[map_fn](example, JPreprocess(height=64, width=96))
    got = TR.MAP_FUNCTIONS[map_fn](example, PreprocessConfig(height=64, width=96))
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(r))
    assert TDP.supported(map_fn) == JDP.supported(map_fn)
    if TDP.supported(map_fn):
        width = TDP.packed_width(map_fn)
        assert width == JDP.packed_width(map_fn)
        packed = np.concatenate([TR._depth_rgb(paths, i) for i in range(width // 3)], axis=-1)[None]
        dev = TDP.build_from_packed(map_fn, _t(packed), PreprocessConfig(height=64, width=96))
        ref_dev = JDP.build_from_packed(map_fn, jnp.asarray(packed), JPreprocess(height=64, width=96))
        np.testing.assert_array_equal(dev.numpy(), np.asarray(ref_dev))
        np.testing.assert_array_equal(dev[0].numpy(), got[0])


# ---------------------------------------------------------------- fusion modules


def _maps(seed, b=2, hw=32):
    rng = np.random.RandomState(seed)
    return [rng.randn(b, hw // s, hw // s, c).astype(np.float32) for s, c in zip((4, 8, 16, 32), CHANNELS)]


def _case(name, rng):
    """(JAX module, port module, inputs as numpy, extra JAX kwargs by mode)."""
    color, depth = _maps(5), _maps(6)
    grad = rng.rand(2, 32, 32, 3).astype(np.float32)
    mask = (rng.rand(2, 32, 32, 1) > 0.3).astype(np.float32)
    image = rng.uniform(-2, 2, (2, 32, 40, 3)).astype(np.float32)
    gray = (rng.randint(1, 256, (2, 32, 40, 1)) * (rng.rand(2, 32, 40, 1) > 0.01)).astype(np.float32)
    return {
        "FeatureFuser": (jfusion.FeatureFuser(), tfusion.FeatureFuser(CHANNELS), (color, depth)),
        "SpatialAttention": (jfusion.SpatialAttention(), tfusion.SpatialAttention(), (color[1],)),
        "FeatureFuserWithSpatialAttention": (jfusion.FeatureFuserWithSpatialAttention(),
                                             tfusion.FeatureFuserWithSpatialAttention(CHANNELS), (color, depth)),
        "RatioPredictor": (jfusion.RatioPredictor(), tfusion.RatioPredictor(CHANNELS), (depth,)),
        "DepthImageRatioPredictor": (jfusion.DepthImageRatioPredictor(), tfusion.DepthImageRatioPredictor(3),
                                     (image,)),
        "IntrinsicsPredictor": (jfusion.IntrinsicsPredictor(), tfusion.IntrinsicsPredictor(1), (gray,)),
        "DepthGradientInjection": (jfusion.DepthGradientInjection(), tfusion.DepthGradientInjection(CHANNELS),
                                   (color, grad)),
        "DepthGradientInjectionWithMask": (jfusion.DepthGradientInjectionWithMask(),
                                           tfusion.DepthGradientInjectionWithMask(CHANNELS), (color, grad, mask)),
    }[name]


def _as_list(out):
    return list(out) if isinstance(out, (list, tuple)) else [out]


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("name", ["FeatureFuser", "SpatialAttention", "FeatureFuserWithSpatialAttention",
                                  "RatioPredictor", "DepthImageRatioPredictor", "IntrinsicsPredictor",
                                  "DepthGradientInjection", "DepthGradientInjectionWithMask"])
def test_fusion_module_matches_jax(name, train, monkeypatch):
    """Outputs (and, in train mode, BatchNorm's new running statistics) with
    the JAX variables loaded by `from_flax(strict=True)`; dropout off."""
    rng = np.random.RandomState(7)
    jmod, tmod, inputs = _case(name, rng)
    monkeypatch.setattr(fnn.Dropout, "__call__", lambda self, x, *a, **k: x)
    for m in tmod.modules():
        if hasattr(m, "p"):
            m.p = 0.0
    jin = jax.tree.map(jnp.asarray, inputs)
    kw = {"deterministic": not train} if name == "DepthImageRatioPredictor" else {}
    v = jax.tree.map(np.asarray, jmod.init(jax.random.PRNGKey(0), *jin, **({"deterministic": True} if kw else {})))
    v = jax.tree.map(np.copy, v)
    for bn in v.get("batch_stats", {}).values():
        bn["mean"] = rng.normal(0, 0.1, bn["mean"].shape).astype(np.float32)
        bn["var"] = rng.uniform(0.5, 1.5, bn["var"].shape).astype(np.float32)
    if train and "batch_stats" in v:
        ref, state = jmod.apply(v, *jin, mutable=["batch_stats"], **kw)
    else:
        ref, state = jmod.apply(v, *jin, **kw), {}
    tmod.load_state_dict(from_flax(v["params"], v.get("batch_stats")), strict=True)
    tmod.train(train)
    tin = jax.tree.map(_t, inputs)
    with torch.no_grad():
        out = tmod(*tin) if name != "DepthImageRatioPredictor" else tmod(*tin, torch.Generator().manual_seed(0))
    for o, r in zip(_as_list(out), _as_list(ref)):
        assert o.dtype == torch.float32
        np.testing.assert_allclose(o.numpy(), np.asarray(r), **MODULE_TOL)
    if state:
        stats = {k: b for k, b in tmod.state_dict().items() if "running" in k}
        for bn, s in state["batch_stats"].items():
            np.testing.assert_allclose(stats[f"{bn}.running_mean"].numpy(), np.asarray(s["mean"]), atol=1e-5, rtol=1e-5)
            np.testing.assert_allclose(stats[f"{bn}.running_var"].numpy(), np.asarray(s["var"]), atol=1e-5, rtol=1e-5)


def test_fusion_modules_need_no_environment_switch():
    """The port runs conv, BN, ReLU: no RGBDSEG_* switch is read."""
    src = open(os.path.join(os.path.dirname(tfusion.__file__), "fusion.py")).read()
    assert "environ" not in src
