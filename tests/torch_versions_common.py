"""Shared inputs of the per-version parity tests (`tests/test_torch_versions_*.py`).

- `jax_variables(version)`: the JAX model's variable tree, its names, shapes
  and dtypes from `jax.eval_shape` of the tiny model's init (no compile), its
  values drawn from seeded numpy: kernels at 1/sqrt(fan in), biases and tables
  small, norm scales near 1, BatchNorm running statistics randomised so that
  their map matters. The port loads the same tree through `from_flax` with
  `strict=True`.
- `frames(version)`: a channel stack of the version's layout from seeded
  numpy: normal RGB; continuous depth in [-2, 2] (no pixel on a DSAM window
  edge); gradients in [0, 1); 0/1 validity masks; and for 0.0.7 an 8-bit gray
  depth with 1% holes (zeros), whose surface normals have invalid points.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from rgbdseg_tpu.config import ModelConfig as JConfig
from rgbdseg_tpu.models.mask2former import Mask2FormerRGBD as JModel
from rgbdseg_torch import versions as TV
from rgbdseg_torch.config import ModelConfig
from rgbdseg_torch.models.mask2former import Mask2FormerRGBD
from rgbdseg_torch.utils.weights import from_flax

HW = 64
NUM_LABELS = 3
VERSIONS = sorted(TV.REGISTRY)


def channels(version: str) -> int:
    return TV.get(version).channels.total


def _walk(tree, path=()):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _walk(tree[k], path + (k,))
        else:
            yield path + (k,), tree[k]


def _put(tree, path, value):
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def _draw(rng, path, shape, collection):
    leaf = path[-1]
    if collection == "batch_stats":
        return rng.uniform(0.5, 1.5, shape) if leaf == "var" else rng.normal(0, 0.1, shape)
    if leaf == "kernel":
        return rng.normal(0, 1 / np.sqrt(np.prod(shape[:-1])), shape)
    if leaf == "scale":
        return 1 + rng.normal(0, 0.1, shape)
    if leaf in ("level_embed", "queries_embedder", "queries_features"):
        return rng.normal(0, 1, shape)
    return rng.normal(0, 0.02, shape)


@functools.lru_cache(maxsize=None)
def _variables(version: str, seed: int):
    cfg = JConfig.tiny(num_labels=NUM_LABELS, version=version)
    shapes = jax.eval_shape(JModel(cfg).init, {"params": jax.random.PRNGKey(0)},
                            jnp.zeros((1, HW, HW, channels(version)), jnp.float32))
    rng = np.random.RandomState(seed)
    v = {}
    for collection in sorted(shapes):
        for path, s in _walk(shapes[collection]):
            _put(v, (collection,) + path, _draw(rng, path, s.shape, collection).astype(s.dtype))
    return cfg, v


def jax_variables(version: str, seed: int = 0):
    """(JAX config, variables as nested dicts of numpy arrays), a fresh copy."""
    cfg, v = _variables(version, seed)
    return cfg, jax.tree.map(np.copy, v)


def port_model(version: str, v) -> Mask2FormerRGBD:
    model = Mask2FormerRGBD(ModelConfig.tiny(num_labels=NUM_LABELS, version=version))
    model.load_state_dict(from_flax(v["params"], v.get("batch_stats")), strict=True)
    return model


def frames(version: str, seed: int = 0, b: int = 2) -> np.ndarray:
    spec = TV.get(version).channels
    rng = np.random.RandomState(seed)
    x = rng.randn(b, HW, HW, spec.total).astype(np.float32)
    for group in ("depth", "fused_depth"):
        if getattr(spec, group) is not None:
            lo, hi = getattr(spec, group)
            x[..., lo:hi] = rng.uniform(-2, 2, (b, HW, HW, hi - lo))
    if spec.gradient is not None:
        lo, hi = spec.gradient
        x[..., lo:hi] = rng.rand(b, HW, HW, hi - lo)
    if spec.gradient_mask is not None:
        x[..., spec.gradient_mask[0]] = rng.rand(b, HW, HW) > 0.3
    if spec.gray_depth is not None:
        x[..., spec.gray_depth[0]] = rng.randint(1, 256, (b, HW, HW)) * (rng.rand(b, HW, HW) > 0.01)
    return x


def to_torch(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


MODEL_TOL = dict(atol=1e-4, rtol=1e-4)


def check_forward(version: str) -> None:
    """Final and auxiliary logits of the eval-mode forward, port against JAX, at MODEL_TOL."""
    cfg, v = jax_variables(version)
    x = frames(version)
    ref = jax.jit(lambda vv, xx: JModel(cfg).apply(vv, xx, deterministic=True))(v, jnp.asarray(x))
    model = port_model(version, v).eval()
    with torch.no_grad():
        out = model(to_torch(x))
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
