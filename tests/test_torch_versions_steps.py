"""Step 0 of the train step for one version of each fusion family, port against
the JAX package, on the CPU at tiny size: 0.0.7 (intrinsics predictor and
in-forward surface normals, DGGM v3), 0.1.1 (dual backbone, FeatureFuser,
DSAM at the fixed ratio), 0.2.0 (the same on CSF-fused depth) and 0.3.0 (dual
backbone, the backbone ratio predictor, DSAM, DGGM v3).

The train-mode forward, the criterion and the backward of both packages see
the same weights (`tests/torch_versions_common.py`), batch and point
coordinates (`_uniform` replaced on both sides, as `tests/test_torch_train.py`
does); dropout is off. Tolerances as `tests/test_torch_train.py`: loss 1e-5
relative, global gradient norm 1e-4 relative, each gradient leaf 1e-4 of its
own largest |value|, BN running statistics 1e-5. Outside 0.4.0 nothing is
detached: the gradient must reach both Swins, the fusers and DSAM; the ratio
predictor of 0.3.0 sets thresholds only, so its gradient is 0 in both
packages; the intrinsics predictor of 0.0.7 feeds only the detached normals,
so it gets none, and one optimizer step leaves it unchanged in both.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as fnn

from rgbdseg_tpu.models.mask2former import Mask2FormerRGBD as JModel
from rgbdseg_tpu.ops import losses as jlosses
from rgbdseg_tpu.train.trainer import _reference_frozen_mask
from rgbdseg_torch.ops import losses as tlosses
from rgbdseg_torch.train.arguments import TrainingArguments
from rgbdseg_torch.train.trainer import TrainBatch, apply_step, make_optimizer, micro_step
from rgbdseg_torch.utils.weights import to_flax
from test_torch_train import _attn_mask_bools, _flat, _optax_chain, _targets, _tree_norm, same_points  # noqa: F401
from torch_versions_common import TV, frames, jax_variables, port_model, to_torch


def _jax_step0(cfg, v, x, masks, classes, valid):
    def loss_fn(p):
        out, mut = JModel(cfg).apply({"params": p, "batch_stats": v.get("batch_stats", {})}, jnp.asarray(x),
                                     deterministic=False, mutable=["batch_stats"],
                                     rngs={"dropout": jax.random.PRNGKey(1), "droppath": jax.random.PRNGKey(2)})
        total, _ = jlosses.mask2former_loss(cfg, out, jnp.asarray(masks), jnp.asarray(classes), jnp.asarray(valid),
                                            jax.random.PRNGKey(3))
        return total, (out, mut.get("batch_stats", {}))

    (loss, (out, stats)), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(v["params"])
    return float(loss), out, jax.device_get(stats), _flat(jax.device_get(grads))


def _zero(flat, prefix):
    return all(not np.any(a) for k, a in flat.items() if k.startswith(prefix))


@pytest.mark.parametrize("version", ["0.0.7", "0.1.1", "0.2.0", "0.3.0"])
def test_step0_loss_grads_and_bn_stats_match_jax(version, same_points, monkeypatch):
    cfg, v = jax_variables(version)
    monkeypatch.setattr(fnn.Dropout, "__call__", lambda self, x, *a, **k: x)
    x = frames(version)
    masks, classes, valid = _targets(np.random.RandomState(8))
    j_loss, j_out, j_stats, ref = _jax_step0(cfg, v, x, masks, classes, valid)

    model = port_model(version, v).train()
    out = model(to_torch(x), torch.Generator().manual_seed(0))
    loss, _ = tlosses.mask2former_loss(model.cfg, out, to_torch(masks), to_torch(classes), to_torch(valid),
                                       torch.Generator().manual_seed(0))
    loss.backward()

    j_masks = list(j_out.aux_mask_logits) + [j_out.masks_queries_logits]
    t_masks = [m.detach() for m in list(out.aux_mask_logits) + [out.masks_queries_logits]]
    for a, b in zip(_attn_mask_bools(j_masks, cfg), _attn_mask_bools(t_masks, cfg)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(loss.item(), j_loss, rtol=1e-5)
    grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p)) for n, p in model.named_parameters()}
    got = _flat(to_flax(grads)[0])
    assert set(got) == set(ref)
    assert all(np.isfinite(a).all() for a in got.values())
    np.testing.assert_allclose(_tree_norm(got), _tree_norm(ref), rtol=1e-4)
    top = max(float(np.abs(r).max()) for r in ref.values())
    for k in ref:
        if k.endswith(("k_proj/bias", "attention/key/bias")):
            # softmax ignores a per-query constant, so the exact gradient of a
            # key bias is 0 (the decoder's, and now that the gradient reaches
            # them the Swins'): both sides hold rounding noise only
            assert max(np.abs(got[k]).max(), np.abs(ref[k]).max()) <= 1e-6 * top, k
            continue
        scale = float(np.abs(ref[k]).max())
        assert np.abs(got[k] - ref[k]).max() <= 1e-4 * scale, (k, np.abs(got[k] - ref[k]).max(), scale)
    new_stats = _flat(to_flax({n: b for n, b in model.state_dict().items() if "running" in n})[1])
    for k, r in _flat(j_stats).items():
        np.testing.assert_allclose(new_stats[k], r, atol=1e-5, rtol=1e-5, err_msg=k)

    # Where the gradient reaches, in both packages. None reaches the ratio
    # predictor (it sets thresholds only), the intrinsics predictor (detached
    # normals), or a depth encoder that feeds only the ratio predictor (0.3.0).
    plm = "pixel_level_module/"
    none = {"ratio_predictor", "intrinsics_predictor"}
    if not TV.get(version).fusion.feature_fuser:
        none.add("depth_encoder")
    for mod in ("encoder", "depth_encoder", "feature_fuser", "dsam_cascade", "dggm", *sorted(none)):
        if any(k.startswith(plm + mod + "/") for k in ref):
            zero = mod in none
            assert _zero(ref, plm + mod + "/") == zero and _zero(got, plm + mod + "/") == zero, mod
    if version == "0.0.7":
        assert all(p.grad is None for p in model.pixel_level_module.intrinsics_predictor.parameters())


def test_0_0_7_step_leaves_intrinsics_predictor_as_jax_does(same_points):
    """0.0.7 on a gray depth with 1% holes (NaN points in the normals): every
    gradient finite; one `micro_step` + `apply_step`, and the JAX trainer's
    optax chain with its reference-frozen mask (`optax.masked(set_to_zero)`)
    on the same gradients (zeros where the port has none, as JAX's): the same
    updated parameters (1e-6, as the optimizer test of
    `tests/test_torch_train.py`), and the intrinsics predictor's bit for bit
    unchanged in both, weight decay on. (Fed each package's own gradients,
    Adam's first step, mu / sqrt(nu), turns their rounding differences at
    gradients near 0 into up to lr: the gradients are held by the step-0 test.)"""
    version = "0.0.7"
    _, v = jax_variables(version)
    x = frames(version)
    assert (x[..., 3] == 0).any()
    masks, classes, valid = _targets(np.random.RandomState(8))
    args = TrainingArguments(learning_rate=1e-3, weight_decay=0.05, warmup_ratio=0.0)

    model = port_model(version, v).train()
    opt = make_optimizer(model, args, 2)
    batch = TrainBatch(to_torch(x), to_torch(masks), to_torch(classes), to_torch(valid))
    loss, _ = micro_step(model, opt, batch, torch.Generator().manual_seed(0))
    assert torch.isfinite(loss)
    assert all(torch.isfinite(p.grad).all() for p in model.parameters() if p.grad is not None)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    grads = to_flax({n: (p.grad if p.grad is not None else torch.zeros_like(p))
                     for n, p in model.named_parameters()})[0]
    apply_step(opt, 1)

    grads = jax.tree.map(jnp.asarray, grads)
    tx = optax.chain(_optax_chain(args, opt.total_steps),
                     optax.masked(optax.set_to_zero(), _reference_frozen_mask))
    step = jax.jit(lambda g, p: optax.apply_updates(p, tx.update(g, tx.init(p), p)[0]))
    j_new = _flat(jax.device_get(step(grads, v["params"])))
    got = _flat(to_flax({n: p.detach() for n, p in model.named_parameters()})[0])
    for k in j_new:
        np.testing.assert_allclose(got[k], j_new[k], atol=1e-6, rtol=0, err_msg=k)
    frozen = [n for n in before if n.startswith("pixel_level_module.intrinsics_predictor.")]
    assert frozen and all(torch.equal(before[n], dict(model.named_parameters())[n]) for n in frozen)
    assert all(np.array_equal(j_new[k], _flat(v["params"])[k]) for k in j_new if "intrinsics_predictor" in k)
    moved = [n for n in before if not torch.equal(before[n], dict(model.named_parameters())[n])]
    assert len(moved) > len(before) // 2
