"""The port's train step against the JAX package's, on the CPU at tiny size.

Inputs come from seeded numpy and go to both packages. The criterion's point
coordinates are injected into both sides by replacing `_uniform` in
`rgbdseg_tpu.ops.losses` and `rgbdseg_torch.ops.losses` with one function of
the requested shape. On CPU tensors the kernel wrappers run their plain
versions, forward and backward, so these tests pin the plain gradients and the
whole step; `tests/test_torch_kernels.py` holds the CUDA kernels against the
plain versions on the card.

Tolerances: 1e-5 for single functions and their gradients (f32 in another
order); for the whole model at step 0, loss 1e-5 relative, global gradient
norm 1e-4 relative, each gradient leaf 1e-4 of its own largest |value| (the
attention key biases, whose exact gradient is 0, within 1e-6 of the largest
leaf's scale; measured worst elsewhere 4.9e-6 of the leaf's scale), BN
running statistics 1e-5 (f32 reductions over ~30 stacked layers, convolutions
that sum in another order, and the JAX BatchNorm's E[x²] - mean² variance);
optimizer 1e-6 after 3 steps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import scipy.optimize
import torch
from flax import linen as fnn

from rgbdseg_tpu.config import ModelConfig as JConfig
from rgbdseg_tpu.models.mask2former import Mask2FormerRGBD as JModel
from rgbdseg_tpu.models.mask2former import ModelOutputs as JOutputs
from rgbdseg_tpu.models import pixel_decoder as jpd
from rgbdseg_tpu.ops import losses as jlosses
from rgbdseg_tpu.ops.kernels import deformable as jdeform
from rgbdseg_tpu.ops.kernels import masked_attention as jmca
from rgbdseg_tpu.ops.matcher import hungarian_batch as j_hungarian
from rgbdseg_tpu.train.trainer import _hf_decay_mask
from rgbdseg_torch.config import ModelConfig, SwinConfig
from rgbdseg_torch.models.mask2former import Mask2FormerRGBD, ModelOutputs
from rgbdseg_torch.models.pixel_decoder import (
    initial_locations,
    offset_bias_grid,
    reference_points_for_shapes,
    sampling_locations,
)
from rgbdseg_torch.models.stochastic import Dropout, drop_path
from rgbdseg_torch.models.swin import SwinBackbone
from rgbdseg_torch.ops import losses as tlosses
from rgbdseg_torch.ops.kernels import LAUNCHES, reset_launches
from rgbdseg_torch.ops.kernels.deformable import (
    deform_sample_level,
    deform_sample_level_plain,
    deform_sample_levels,
)
from rgbdseg_torch.ops.kernels.masked_attention import masked_cross_attention
from rgbdseg_torch.ops.matcher import hungarian_batch
from rgbdseg_torch.ops.resize import resize_bilinear
from rgbdseg_torch.train.arguments import TrainingArguments
from rgbdseg_torch.train.optim import AdamW, is_decayed
from rgbdseg_torch.train.trainer import TrainBatch, make_optimizer, train_step
from rgbdseg_torch.utils.weights import from_flax, init_weights, to_flax

HW = 64
NUM_LABELS = 3


def _softmax(x):
    e = np.exp(x - x.max(-1, keepdims=True))
    return e / e.sum(-1, keepdims=True)


def _coords(shape):
    """The same uniform coordinates for a given shape on both sides."""
    rng = np.random.RandomState(abs(hash(tuple(shape))) % (2**31))
    return rng.uniform(0.0, 1.0, shape).astype(np.float32)


@pytest.fixture
def same_points(monkeypatch):
    monkeypatch.setattr(jlosses, "_uniform", lambda rng, shape: jnp.asarray(_coords(shape)))
    monkeypatch.setattr(tlosses, "_uniform", lambda generator, shape: torch.from_numpy(_coords(shape)))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, path) if isinstance(v, dict) else {path: np.asarray(v)})
    return out


# ---------------------------------------------------------------- K1 backward


def _k1_level_case(kind, bh=2, l=60, npts=4, h=7, w=9, hd=16, seed=0):
    rng = np.random.RandomState(seed)
    if kind == "random_out_of_bounds":
        gx = rng.uniform(-2.5, w + 1.5, (bh, l, npts))
        gy = rng.uniform(-2.5, h + 1.5, (bh, l, npts))
    elif kind == "half_integer":
        gx = rng.randint(-2, w + 2, (bh, l, npts)) + 0.5
        gy = rng.randint(-2, h + 2, (bh, l, npts)) + 0.5
    elif kind == "integer":  # the borders -1, 0, w-1, w and beyond included
        gx = rng.randint(-2, w + 2, (bh, l, npts))
        gy = rng.randint(-2, h + 2, (bh, l, npts))
    else:  # integer in x, random in y
        gx = rng.randint(-2, w + 2, (bh, l, npts))
        gy = rng.uniform(-1.5, h + 0.5, (bh, l, npts))
    aw = _softmax(rng.randn(bh, l, npts))
    v = rng.randn(bh, h * w, hd)
    g = rng.randn(bh, l, hd)
    return [a.astype(np.float32) for a in (gx, gy, aw, v, g)], h, w


@pytest.mark.parametrize("kind", ["random_out_of_bounds", "half_integer", "integer", "integer_x_random_y"])
def test_k1_level_backward_matches_jax_vjp(kind):
    """d gx, d gy, d aw, d v of the per-level K1 (autograd Function, plain
    backward on the CPU) against jax.vjp of the tent twin, 1e-5: at exactly
    integer coordinates the JAX tent subgradient, not the bilinear one."""
    (gx, gy, aw, v, g), h, w = _k1_level_case(kind)
    _, vjp = jax.vjp(lambda a, b, c, d: jdeform.tent_sample_level_xla(a, b, c, d, h, w), gx, gy, aw, v)
    ref = vjp(g)
    ts = [torch.from_numpy(a).requires_grad_() for a in (gx, gy, aw, v)]
    deform_sample_level(*ts, h, w).backward(torch.from_numpy(g))
    for t, r in zip(ts, ref):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(r), atol=1e-5, rtol=1e-5)
    if kind == "integer":  # the bilinear (floor-based) gradient differs there
        floor = [t.detach().requires_grad_() for t in ts]
        deform_sample_level_plain(*floor, h, w).backward(torch.from_numpy(g))
        assert np.abs(floor[0].grad.numpy() - np.asarray(ref[0])).max() > 1e-2


def _jax_levels(value, loc, weights, shapes):
    """The JAX model's multi-level sampling from its per-level twin, as one function."""
    b, l, nh, nl, npts, _ = loc.shape
    hd = value.shape[-1]
    out = jnp.zeros((b * nh, l, hd), jnp.float32)
    start = 0
    for lvl, (h, w) in enumerate(shapes):
        v = value[:, start : start + h * w].transpose(0, 2, 1, 3).reshape(b * nh, h * w, hd)
        coords = loc[:, :, :, lvl].transpose(0, 2, 1, 3, 4).reshape(b * nh, l, npts, 2)
        aw = weights[:, :, :, lvl].transpose(0, 2, 1, 3).reshape(b * nh, l, npts)
        out = out + jdeform.tent_sample_level_xla(coords[..., 0] * w - 0.5, coords[..., 1] * h - 0.5, aw, v, h, w)
        start += h * w
    return out.reshape(b, nh, l, hd).transpose(0, 2, 1, 3).reshape(b, l, nh * hd)


@pytest.mark.parametrize("geometry", ["model", "random", "spread", "edge"])
def test_k1_levels_backward_matches_jax_vjp(geometry):
    """All levels through `deform_sample_levels` (as an encoder layer calls it)
    against jax.vjp of the JAX model's per-level sum, 1e-5. "model" is the
    seeded layer's geometry, which puts many samples on exact integers;
    "spread" and "edge" keep its reference points with offsets uniform in +-12
    pixels, or +5 pixels in x and y (samples off the map's last rows and
    columns), as the CUDA tests do."""
    shapes = ((8, 10), (4, 5), (2, 3))
    nh, hd, b = 4, 16, 2
    rng = np.random.RandomState(1)
    l = sum(h * w for h, w in shapes)
    value = rng.randn(b, l, nh, hd).astype(np.float32)
    if geometry == "model":
        loc = np.repeat(initial_locations(shapes, nh, 4).numpy(), b, axis=0)
    elif geometry == "random":
        loc = rng.uniform(-0.1, 1.1, (b, l, nh, 3, 4, 2)).astype(np.float32)
    else:
        ref = reference_points_for_shapes(shapes)[None, :, None, :].expand(b, -1, 3, 2)
        shape = (b, l, nh, 3, 4, 2)
        off = rng.uniform(-12.0, 12.0, shape) if geometry == "spread" else np.full(shape, 5.0)
        loc = sampling_locations(ref, torch.from_numpy(off.astype(np.float32)), shapes).numpy()
    weights = _softmax(rng.randn(b, l, nh, 12)).reshape(b, l, nh, 3, 4).astype(np.float32)
    g = rng.randn(b, l, nh * hd).astype(np.float32)
    _, vjp = jax.vjp(lambda a, c, d: _jax_levels(a, c, d, shapes), value, loc, weights)
    ref = vjp(g)
    ts = [torch.from_numpy(a).requires_grad_() for a in (value, loc, weights)]
    deform_sample_levels(ts[0], shapes, ts[1], ts[2]).backward(torch.from_numpy(g))
    for t, r in zip(ts, ref):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(r), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("shapes", [((15, 20), (30, 40), (60, 80)), ((7, 9), (13, 17), (3, 11))])
def test_sampling_locations_match_jitted_jax_bitwise(shapes):
    """The encoder's reference points and sampling locations (the seeded offsets
    and random ones) have the JAX package's bits under jit: K1's gradient jumps
    at exact integer samples, which the seeded geometry hits, so one ulp there
    moves the sampling offsets' gradient. 480x640's levels and odd sizes."""
    nh, nl, npts = 8, 3, 4
    l = sum(h * w for h, w in shapes)
    rng = np.random.RandomState(0)
    seeded = np.broadcast_to(offset_bias_grid(nh, nl, npts).reshape(1, 1, nh, nl, npts, 2), (1, l, nh, nl, npts, 2))
    offsets = np.concatenate([seeded, (rng.randn(1, l, nh, nl, npts, 2) * 3).astype(np.float32)])

    def j_locations(zero, off):  # the JAX encoder layer's location arithmetic
        ref = jnp.broadcast_to(jpd.reference_points_for_shapes(shapes, zero)[None, :, None, :], (1, l, nl, 2))
        normalizer = jnp.asarray([[w, h] for (h, w) in shapes], jnp.float32)
        return ref[:, :, None, :, None, :] + off / normalizer[None, None, None, :, None, :]

    j_ref = np.asarray(jax.jit(lambda z: jpd.reference_points_for_shapes(shapes, z))(0.0))
    ref = reference_points_for_shapes(shapes)
    np.testing.assert_array_equal(ref.numpy(), j_ref)
    got = sampling_locations(ref[None, :, None, :].expand(1, -1, nl, 2), torch.from_numpy(offsets), shapes)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax.jit(j_locations)(0.0, offsets)))


# ---------------------------------------------------------------- K3 backward


@pytest.mark.parametrize("nk", [64, 300])
def test_k3_backward_matches_jax_vjp(nk):
    """d q, d k, d v of K3 on the CPU (autograd of the plain version) against
    jax.vjp of the JAX twin, all-blocked rows included, 1e-5; no mask gradient."""
    rng = np.random.RandomState(2)
    b, h, nq, hd = 2, 4, 20, 16
    q = (rng.randn(b, h, nq, hd) * hd**-0.5).astype(np.float32)
    k, v = (rng.randn(b, h, nk, hd).astype(np.float32) for _ in range(2))
    m = rng.randn(b, nq, nk).astype(np.float32)
    m[:, :3] = -np.abs(m[:, :3]) - 0.1  # all blocked: exempted
    ab = np.all(m < 0.0, axis=-1)
    g = rng.randn(b, h, nq, hd).astype(np.float32)
    _, vjp = jax.vjp(lambda a, c, d: jmca.masked_cross_attention_xla(a, c, d, m, ab), q, k, v)
    ref = vjp(g)
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    mt = torch.from_numpy(m).requires_grad_()
    masked_cross_attention(*ts, mt, torch.from_numpy(ab)).backward(torch.from_numpy(g))
    for t, r in zip(ts, ref):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(r), atol=1e-5, rtol=1e-5)
    assert mt.grad is None or not mt.grad.any()


# ---------------------------------------------------------------- criterion and matcher


def _targets(rng, b=2, t=4, n_valid=(3, 2)):
    """Box masks at HW x HW; slots past n_valid are padding."""
    masks = np.zeros((b, t, HW, HW), np.float32)
    classes = np.zeros((b, t), np.int32)
    valid = np.zeros((b, t), bool)
    for i in range(b):
        for j in range(n_valid[i]):
            y0, x0 = rng.randint(0, HW - 16, 2)
            hh, ww = rng.randint(8, 32, 2)
            masks[i, j, y0 : y0 + hh, x0 : x0 + ww] = 1.0
            classes[i, j] = rng.randint(0, NUM_LABELS)
            valid[i, j] = True
    return masks, classes, valid


def test_criterion_per_layer_and_logit_grads_match_jax(same_points):
    """`mask2former_loss` at ModelConfig.tiny on random logits of 4 layers:
    total, each weighted per-layer loss and the gradients w.r.t. every layer's
    class and mask logits against the JAX criterion, 1e-5."""
    rng = np.random.RandomState(3)
    cfg = JConfig.tiny(num_labels=NUM_LABELS, version="0.4.0")
    n_layers, b, q = cfg.decoder_layers, 2, cfg.num_queries
    cls = (rng.randn(n_layers, b, q, NUM_LABELS + 1) * 2).astype(np.float32)
    msk = (rng.randn(n_layers, b, q, HW // 4, HW // 4) * 3).astype(np.float32)
    masks, classes, valid = _targets(rng)

    def jloss(c, m):
        out = JOutputs(c[-1], m[-1], tuple(c[:-1]), tuple(m[:-1]))
        return jlosses.mask2former_loss(cfg, out, jnp.asarray(masks), jnp.asarray(classes), jnp.asarray(valid),
                                        jax.random.PRNGKey(0))

    (j_total, j_layers), (j_dc, j_dm) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(cls, msk)
    tc, tm = (torch.from_numpy(a).requires_grad_() for a in (cls, msk))
    out = ModelOutputs(tc[-1], tm[-1], tuple(tc[:-1]), tuple(tm[:-1]))
    total, layers = tlosses.mask2former_loss(
        ModelConfig.tiny(num_labels=NUM_LABELS, version="0.4.0"), out, torch.from_numpy(masks),
        torch.from_numpy(classes), torch.from_numpy(valid), torch.Generator().manual_seed(0))
    total.backward()
    np.testing.assert_allclose(total.item(), float(j_total), rtol=1e-5)
    for key in tlosses.LOSS_KEYS:
        np.testing.assert_allclose(layers[key].detach().numpy(), np.asarray(j_layers[key]), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(tc.grad.numpy(), np.asarray(j_dc), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(tm.grad.numpy(), np.asarray(j_dm), atol=1e-5, rtol=1e-5)


def test_matcher_total_cost_matches_scipy_and_jax():
    """Padded targets (uniform-0 rows): the real rows' total cost equals
    scipy's optimum on the real rows alone and the JAX solver's."""
    rng = np.random.RandomState(4)
    cost = rng.randn(3, 6, 10).astype(np.float32)
    n_valid = (6, 4, 1)
    for i, n in enumerate(n_valid):
        cost[i, n:] = 0.0
    got = hungarian_batch(torch.from_numpy(cost)).numpy()
    ref = np.asarray(j_hungarian(jnp.asarray(cost)))
    for i, n in enumerate(n_valid):
        assert len(set(got[i])) == cost.shape[1]  # distinct queries, padding rows included
        r, c = scipy.optimize.linear_sum_assignment(cost[i, :n])
        best = cost[i, r, c].sum()
        np.testing.assert_allclose(cost[i, np.arange(n), got[i, :n]].sum(), best, rtol=1e-6)
        np.testing.assert_allclose(cost[i, np.arange(n), ref[i, :n]].sum(), best, rtol=1e-6)


# ---------------------------------------------------------------- optimizer


COEF = (0.01, 1.0, 0.02)  # loss scale per step: gradient norms below and above the clip


def _optax_chain(args, total_steps):
    """The JAX trainer's optax chain (`Trainer._init_state`), built the same way."""
    import math

    warmup = math.ceil(args.warmup_ratio * total_steps)
    schedule = optax.join_schedules(
        [optax.linear_schedule(0.0, args.learning_rate, max(warmup, 1)),
         optax.linear_schedule(args.learning_rate, 0.0, max(total_steps - warmup, 1))],
        [max(warmup, 1)] if warmup > 0 else [0],
    )
    return optax.chain(
        optax.clip_by_global_norm(args.max_grad_norm),
        optax.adamw(schedule, b1=args.adam_beta1, b2=args.adam_beta2, eps=args.adam_epsilon,
                    weight_decay=args.weight_decay, mask=_hf_decay_mask),
    )


def test_optimizer_three_coupled_steps_match_optax():
    """A small tree with flax-style names, a quadratic loss on each side (so each
    side's gradients follow its own parameters), one parameter the loss does not
    reach (None gradient in torch, zeros in JAX: optax still decays it), warmup
    and clipping that triggers in some steps: parameters after 3 steps within 1e-6."""
    rng = np.random.RandomState(5)
    shapes = {
        "enc.stage0_block0.norm1.weight": (6,), "enc.stage0_block0.norm1.bias": (6,),
        "enc.stage0_block0.mlp_fc1.weight": (5, 6), "enc.stage0_block0.mlp_fc1.bias": (5,),
        "enc.stage0_block0.attention.relative_position_bias_table": (9, 2),
        "pix.input_proj0_norm.weight": (4,), "pix.input_proj0_conv.weight": (4, 3, 1, 1),
        "pix.level_embed": (3, 4), "ratio.scales_bn.weight": (4,), "ratio.fc0.weight": (2, 4),
    }
    unused = "ratio.fc0.weight"
    init = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    targets = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    args = TrainingArguments(learning_rate=0.05, weight_decay=0.1, warmup_ratio=0.2, max_grad_norm=4.0)
    total_steps = 10

    params = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in init.items()}
    opt = AdamW(params.items(), args, total_steps)
    norms = []
    for step in range(3):
        opt.zero_grad(set_to_none=True)
        loss = sum(((p - torch.from_numpy(targets[k])) ** 2 * COEF[step]).sum()
                   for k, p in params.items() if k != unused)
        loss.backward()
        norms.append(opt.step().item())
    assert min(norms) < args.max_grad_norm < max(norms)  # clipping both ways

    jp, _ = to_flax({k: torch.from_numpy(v) for k, v in init.items()})
    jt, _ = to_flax({k: torch.from_numpy(v) for k, v in targets.items()})
    tx = _optax_chain(args, total_steps)
    state = tx.init(jp)
    unused_path = ("ratio", "fc0", "kernel")
    for step in range(3):
        def loss_fn(p):
            return sum(jnp.sum((a - t) ** 2 * COEF[step])
                       for path, a, t in zip(_paths(p), jax.tree.leaves(p), jax.tree.leaves(jt))
                       if path != unused_path)
        grads = jax.grad(loss_fn)(jp)
        updates, state = tx.update(grads, state, jp)
        jp = optax.apply_updates(jp, updates)
    got, ref = _flat(to_flax({k: p.detach() for k, p in params.items()})[0]), _flat(jax.device_get(jp))
    assert set(got) == set(ref)
    for path in ref:
        np.testing.assert_allclose(got[path], ref[path], atol=1e-6, rtol=0, err_msg=path)
    assert not is_decayed("enc.stage0_block0.norm1.weight") and is_decayed("pix.input_proj0_norm.weight")


def _paths(tree):
    return [tuple(str(getattr(k, "key", k)) for k in path) for path, _ in jax.tree_util.tree_leaves_with_path(tree)]


# ---------------------------------------------------------------- weights, randomness


def test_to_flax_inverts_from_flax():
    cfg = JConfig.tiny(num_labels=NUM_LABELS, version="0.4.0")
    shapes = jax.eval_shape(JModel(cfg).init, {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, HW, HW, 10), jnp.float32))
    rng = np.random.RandomState(6)
    v = jax.tree.map(lambda s: rng.randn(*s.shape).astype(s.dtype), shapes)
    params, stats = to_flax(from_flax(v["params"], v["batch_stats"]))
    for mine, ref in ((params, v["params"]), (stats, v["batch_stats"])):
        a, b = _flat(mine), _flat(ref)
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_dropout_and_drop_path_semantics():
    """Keep-prob scaling, per-sample drop path, determinism under a seeded
    generator, identity in eval mode and at rate 0."""
    x = torch.ones(4000, 8)
    d = Dropout(0.3)
    y = d(x, torch.Generator().manual_seed(0))
    vals = np.unique(y.numpy())
    assert len(vals) == 2 and vals[0] == 0.0 and np.isclose(vals[1], 1 / 0.7, rtol=1e-6)
    assert abs((y != 0).float().mean().item() - 0.7) < 0.03
    torch.testing.assert_close(y, d(x, torch.Generator().manual_seed(0)))
    assert not torch.equal(y, d(x, torch.Generator().manual_seed(1)))
    d.p = 0.0
    assert d(x, None) is x
    d.p = 0.3
    d.eval()
    assert d(x, None) is x

    z = drop_path(torch.ones(2000, 3, 4, 5), 0.25, True, torch.Generator().manual_seed(0))
    per_sample = z.reshape(2000, -1)
    assert ((per_sample == 0).all(1) | (per_sample == 1 / 0.75).all(1)).all()
    assert abs((per_sample[:, 0] != 0).float().mean().item() - 0.75) < 0.04
    torch.testing.assert_close(z, drop_path(torch.ones(2000, 3, 4, 5), 0.25, True, torch.Generator().manual_seed(0)))
    x = torch.randn(3, 4)
    assert drop_path(x, 0.25, False, None) is x and drop_path(x, 0.0, True, None) is x
    with pytest.raises(ValueError, match="Generator"):
        drop_path(x, 0.25, True, None)


def test_swin_drop_path_schedule_and_train_forward_determinism():
    """drop_path_rate is scheduled linearly over the blocks (0 .. 0.3 for
    Swin-T); a train-mode forward is a function of the generator's seed."""
    full = SwinBackbone(SwinConfig())
    rates = [m.drop_path_rate for n, m in full.named_children() if "_block" in n]
    np.testing.assert_allclose(rates, np.linspace(0, 0.3, 12))
    cfg = SwinConfig(embed_dim=16, depths=(2, 2, 2, 2), num_heads=(1, 1, 2, 2), drop_path_rate=0.5)
    net = SwinBackbone(cfg).train()
    x = torch.randn(2, 64, 64, 3)
    a = net(x, torch.Generator().manual_seed(0))
    b = net(x, torch.Generator().manual_seed(0))
    c = net(x, torch.Generator().manual_seed(1))
    assert all(torch.equal(i, j) for i, j in zip(a, b))
    assert not all(torch.equal(i, j) for i, j in zip(a, c))


# ---------------------------------------------------------------- the whole step


def _frames(seed=0, b=2):
    rng = np.random.RandomState(seed)
    x = rng.randn(b, HW, HW, 10).astype(np.float32)
    x[..., 3:6] = rng.uniform(-2, 2, (b, HW, HW, 3))
    x[..., 6:9] = rng.rand(b, HW, HW, 3)
    x[..., 9] = rng.rand(b, HW, HW) > 0.3
    return x


@pytest.fixture(scope="module")
def tiny_variables():
    cfg = JConfig.tiny(num_labels=NUM_LABELS, version="0.4.0")
    v = jax.jit(JModel(cfg).init)({"params": jax.random.PRNGKey(1)}, jnp.zeros((1, HW, HW, 10), jnp.float32))
    return cfg, jax.tree.map(lambda a: np.asarray(a).copy(), v)


def _attn_mask_bools(mask_logits, cfg):
    """Each layer's next attention mask (resized logits < 0), as the decoder builds it."""
    sizes = [(HW // s, HW // s) for s in (32, 16, 8)]
    out = []
    for i, m in enumerate(mask_logits[:-1]):
        t = torch.as_tensor(np.asarray(m))
        am = resize_bilinear(t.permute(0, 2, 3, 1), sizes[i % 3]).permute(0, 3, 1, 2)
        out.append((am < 0).numpy())
    return out


def _tree_norm(flat):
    return np.sqrt(sum(float((a.astype(np.float64) ** 2).sum()) for a in flat.values()))


def test_step0_loss_grads_and_bn_stats_match_jax(tiny_variables, same_points, monkeypatch):
    """The tiny 0.4.0 model in train mode, dropout off on both sides (flax's
    Dropout replaced by the identity; p = 0 on the port's), same weights,
    batch and points: loss, every gradient leaf through `to_flax`, and the new
    BatchNorm running statistics against jax.value_and_grad of the JAX model
    with mutable batch_stats and its criterion. The attention-mask booleans of
    both forwards must agree, so that a threshold flip near logit 0 cannot hide
    or fake a gap."""
    cfg, v = tiny_variables
    monkeypatch.setattr(fnn.Dropout, "__call__", lambda self, x, *a, **k: x)
    x = _frames()
    masks, classes, valid = _targets(np.random.RandomState(8))

    def loss_fn(p):
        out, mut = JModel(cfg).apply({"params": p, "batch_stats": v["batch_stats"]}, jnp.asarray(x),
                                     deterministic=False, mutable=["batch_stats"],
                                     rngs={"dropout": jax.random.PRNGKey(1), "droppath": jax.random.PRNGKey(2)})
        total, _ = jlosses.mask2former_loss(cfg, out, jnp.asarray(masks), jnp.asarray(classes), jnp.asarray(valid),
                                            jax.random.PRNGKey(3))
        return total, (out, mut["batch_stats"])

    (j_loss, (j_out, j_stats)), j_grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(v["params"])

    model = Mask2FormerRGBD(ModelConfig.tiny(num_labels=NUM_LABELS, version="0.4.0"))
    model.load_state_dict(from_flax(v["params"], v["batch_stats"]), strict=True)
    ratio = model.pixel_level_module.ratio_predictor
    ratio.dropout0.p = ratio.dropout1.p = 0.0
    model.train()
    reset_launches()
    out = model(torch.from_numpy(x), torch.Generator().manual_seed(0))
    loss, _ = tlosses.mask2former_loss(model.cfg, out, torch.from_numpy(masks), torch.from_numpy(classes),
                                       torch.from_numpy(valid), torch.Generator().manual_seed(0))
    loss.backward()
    assert set(LAUNCHES.values()) == {0}

    j_masks = list(j_out.aux_mask_logits) + [j_out.masks_queries_logits]
    t_masks = [m.detach() for m in list(out.aux_mask_logits) + [out.masks_queries_logits]]
    for a, b in zip(_attn_mask_bools(j_masks, cfg), _attn_mask_bools(t_masks, cfg)):
        np.testing.assert_array_equal(a, b)

    np.testing.assert_allclose(loss.item(), float(j_loss), rtol=1e-5)
    grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p)) for n, p in model.named_parameters()}
    got, ref = _flat(to_flax(grads)[0]), _flat(jax.device_get(j_grads))
    assert set(got) == set(ref)
    np.testing.assert_allclose(_tree_norm(got), _tree_norm(ref), rtol=1e-4)
    top = max(float(np.abs(r).max()) for r in ref.values())
    for k in ref:
        if k.endswith("k_proj/bias"):
            # softmax ignores a per-query constant, so the exact gradient is 0:
            # both sides hold rounding noise only
            assert max(np.abs(got[k]).max(), np.abs(ref[k]).max()) <= 1e-6 * top, k
            continue
        scale = float(np.abs(ref[k]).max())
        assert np.abs(got[k] - ref[k]).max() <= 1e-4 * scale, (k, np.abs(got[k] - ref[k]).max(), scale)
    new_stats = _flat(to_flax({n: b for n, b in model.state_dict().items() if "running" in n})[1])
    for k, r in _flat(jax.device_get(j_stats)).items():
        np.testing.assert_allclose(new_stats[k], r, atol=1e-5, rtol=1e-5, err_msg=k)


def test_train_step_runs_on_cpu_and_updates_everything():
    """Two `train_step`s of the tiny 0.4.0 model with dropout and drop path on:
    finite losses and norms, every parameter moves except the ratio predictor's
    undecayed ones (no gradient reaches it; its decayed ones move by the decay
    alone), BN running stats move; no kernel launch."""
    cfg = ModelConfig.tiny(num_labels=NUM_LABELS, version="0.4.0")
    cfg = cfg.replace(backbone=SwinConfig(embed_dim=32, depths=(1, 1, 1, 1), num_heads=(2, 2, 4, 4),
                                          drop_path_rate=0.3))
    model = init_weights(Mask2FormerRGBD(cfg), seed=0)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    args = TrainingArguments(learning_rate=1e-3, weight_decay=0.05)
    opt = make_optimizer(model, args, num_examples=8)
    masks, classes, valid = _targets(np.random.RandomState(9))
    batch = TrainBatch(torch.from_numpy(_frames(1)), torch.from_numpy(masks), torch.from_numpy(classes),
                       torch.from_numpy(valid))
    gen = torch.Generator().manual_seed(0)
    reset_launches()
    for _ in range(2):
        loss, per_layer, gnorm = train_step(model, opt, batch, gen)
        assert torch.isfinite(loss) and torch.isfinite(gnorm) and gnorm > 0
        assert per_layer["loss_mask"].shape == (cfg.decoder_layers,)
    assert set(LAUNCHES.values()) == {0}
    after = model.state_dict()
    moved = {k for k in before if not torch.equal(before[k], after[k])}
    # No gradient reaches the backbone (0.4.0 fuses detached copies of its maps)
    # or the ratio predictor: there only the decayed parameters move.
    no_grad = ("pixel_level_module.encoder.", "pixel_level_module.ratio_predictor.")
    params = {n for n, _ in model.named_parameters() if is_decayed(n) or not n.startswith(no_grad)}
    assert params <= moved, sorted(params - moved)[:5]
    assert any("running_mean" in k for k in moved) and opt.count == 2
