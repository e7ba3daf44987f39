"""The rest of the port's 0.4.0 train step against the JAX package, on the CPU
at tiny size: arguments, target compaction and packing, packed frames built
inside the step, gradient accumulation, the bf16 policy and the matmul
precision switch.

Tolerances, and why:
- `parse_args`, `compact_targets` (the packed twin too): equal, bit for bit;
- a compacted, bit-packed batch of raw uint8 frames against the same batch
  padded, as float masks and a float stack built on the CPU: loss within
  1e-6 relative and every gradient within 1e-6 of its leaf's largest |value|
  (the criterion's normaliser and sums run over 4 slots instead of 8), with
  slot-stable point coordinates injected, as `tests/test_compaction.py`
  does for JAX (without them the point draws of 4 and 8 slots are different
  streams);
- two accumulated micro-batches and one apply against the JAX
  `_accum_step_fn` x 2 + `_apply_step_fn` semantics (the gradients summed,
  divided by the count, then the optax chain): parameters after the step
  within 1e-5, the mean gradient's norm 1e-4 relative (f32 gradients in
  another order, as in `tests/test_torch_train.py`);
- the bf16 policy against the JAX `_cast_bf16` path (f32 master parameters,
  a bfloat16 copy of them and of the pixels in the forward, f32 losses):
  every module's output dtype equal to the JAX module's, in train and eval
  mode; the loss within 1e-2 and the gradient norm within 2e-2 relative of
  the JAX bf16 step (measured 1.7e-3 and 5.3e-3 on this tiny model), and
  each nearer to the JAX bf16 value than the JAX bf16 value is to its own
  f32 one (measured 2.5e-2 and 1.4e-2): the two packages round in bfloat16
  at the same places, and what is left is where each accumulates.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as fnn

from rgbdseg_tpu.config import ModelConfig as JConfig
from rgbdseg_tpu.data.pipeline import compact_targets as j_compact_targets
from rgbdseg_tpu.models.mask2former import Mask2FormerRGBD as JModel
from rgbdseg_tpu.ops import losses as jlosses
from rgbdseg_tpu.train import arguments as jargs
from rgbdseg_torch.config import ModelConfig, PreprocessConfig
from rgbdseg_torch.data.device_preprocess import build_pixels
from rgbdseg_torch.data.pipeline import Batch, compact_targets
from rgbdseg_torch.models.mask2former import Mask2FormerRGBD
from rgbdseg_torch.ops import losses as tlosses
from rgbdseg_torch.ops.kernels import LAUNCHES, reset_launches
from rgbdseg_torch.train import arguments as targs
from rgbdseg_torch.train.optim import global_norm
from rgbdseg_torch.train.trainer import (
    apply_step,
    build_training,
    forward,
    make_optimizer,
    micro_step,
    put_batch,
    set_matmul_precision,
    train_step,
)
from rgbdseg_torch.utils.weights import from_flax, init_weights, to_flax
from test_torch_train import _coords, _flat, _frames, _optax_chain, _targets, _tree_norm

HW = 64
NUM_LABELS = 3

# ---------------------------------------------------------------- arguments


ARGV = ["--version", "0.4.0", "--max_instances", "32", "--bf16", "true", "--gradient_accumulation_steps", "2",
        "--learning_rate", "3e-4", "--ignore_index", "255", "--save_total_limit", "5", "--pack_targets", "no",
        "--matmul_precision", "bfloat16", "--model_config_json", "m.json", "--num_train_epochs", "2.5"]


def test_parse_args_equals_jax(tmp_path):
    """The same dataclasses (names, defaults, values) from flags and from a JSON file."""
    for argv in ([], ARGV):
        got, ref = targs.parse_args(argv), jargs.parse_args(argv)
        assert [dataclasses.asdict(x) for x in got] == [dataclasses.asdict(x) for x in ref]
    cfg = {"version": "0.4.0", "image_height": 480, "bf16": True, "gradient_accumulation_steps": 4, "seed": 7}
    path = tmp_path / "c.json"
    path.write_text(json.dumps(cfg))
    got, ref = targs.parse_args([str(path)]), jargs.parse_args([str(path)])
    assert [dataclasses.asdict(x) for x in got] == [dataclasses.asdict(x) for x in ref]
    assert [f.name for f in dataclasses.fields(targs.TrainingArguments)] == \
        [f.name for f in dataclasses.fields(jargs.TrainingArguments)]


@pytest.mark.parametrize("field,value", [("num_devices", 2), ("model_parallel_size", 2)])
def test_unported_arguments_raise_naming_roadmap(field, value):
    args = targs.TrainingArguments(**{field: value})
    with pytest.raises(NotImplementedError, match=f"{field}.*ROADMAP.md §1 item"):
        build_training(ModelConfig.tiny(num_labels=NUM_LABELS, version="0.4.0"), args, 4, device="cpu")
    assert set(targs.UNPORTED) == {"num_devices", "model_parallel_size"}


@pytest.mark.parametrize("field,value", [("push_to_hub", True), ("profile_start_step", 1),
                                         ("resume_from_checkpoint", "out/checkpoint-3")])
def test_ported_arguments_are_accepted(field, value):
    """The epoch loop honours these now (train/trainer.py::Trainer, train/hub.py)."""
    args = targs.TrainingArguments(**{field: value})
    targs.check_supported(args)
    build_training(ModelConfig.tiny(num_labels=NUM_LABELS, version="0.4.0"), args, 4, device="cpu")


def test_optimizer_steps_count_accumulation_as_jax():
    """An epoch is ceil(ceil(n / batch) / accumulation) optimizer steps (`Trainer._steps_per_epoch`)."""
    model = torch.nn.Linear(2, 2)
    for n, b, ga, epochs, total in ((10, 2, 2, 1, 3), (10, 2, 1, 2, 10), (7, 3, 4, 3.0, 3), (1, 4, 2, 1, 1)):
        args = targs.TrainingArguments(per_device_train_batch_size=b, gradient_accumulation_steps=ga,
                                       num_train_epochs=epochs, learning_rate=1.0)
        opt = make_optimizer(model, args, n)
        assert opt.schedule(0) == 1.0 and opt.schedule(total) == 0.0 and opt.schedule(total - 1) > 0.0


def test_matmul_precision_switch():
    before = (torch.get_float32_matmul_precision(), torch.backends.cudnn.allow_tf32)
    try:
        for value, torch_value, tf32 in (("bfloat16", "medium", True), ("bfloat16_3x", "high", True),
                                         ("float32", "highest", False)):
            set_matmul_precision(value)
            assert (torch.get_float32_matmul_precision(), torch.backends.cudnn.allow_tf32) == (torch_value, tf32)
        with pytest.raises(ValueError, match="matmul_precision"):
            set_matmul_precision("tf32")
    finally:
        torch.set_float32_matmul_precision(before[0])
        torch.backends.cudnn.allow_tf32 = before[1]


# ---------------------------------------------------------------- compaction and packing


def _scattered_targets(rng, b=3, t=20, h=6, w=5):
    masks = (rng.rand(b, t, h, w) > 0.5).astype(np.float32)
    classes = rng.randint(0, 5, (b, t)).astype(np.int32)
    valid = np.zeros((b, t), bool)
    valid[0, [0, 3, 5]] = True
    valid[1, [2, 7, 11, 13, 15, 16, 17, 18, 19]] = True  # 9 real: bucket 16, two past the slice point
    valid[2, [19]] = True
    return masks, classes, valid


@pytest.mark.parametrize("case", ["valid_past_slice", "packed_valid_first", "bucket_covers_t", "empty"])
def test_compact_targets_equals_jax(case):
    rng = np.random.RandomState(0)
    masks, classes, valid = _scattered_targets(rng)
    floor = 8
    if case == "packed_valid_first":
        valid = np.zeros_like(valid)
        valid[0, :3], valid[1, :7] = True, True
    elif case == "bucket_covers_t":
        floor = 32
    elif case == "empty":
        valid, floor = np.zeros_like(valid), 2
    packed = np.packbits(masks.astype(bool).reshape(*masks.shape[:2], -1), axis=-1)
    for extra in ({}, {"packed": packed}):
        got = compact_targets(masks, classes, valid, floor, **extra)
        ref = j_compact_targets(masks, classes, valid, floor, **extra)
        assert len(got) == len(ref) == 3 + len(extra)
        for g, r in zip(got, ref):
            assert g.dtype == r.dtype
            np.testing.assert_array_equal(g, r)
    if case == "valid_past_slice":
        assert got[0].shape[1] == 16 and got[2].sum() == valid.sum()
        np.testing.assert_array_equal(np.unpackbits(got[3], axis=-1)[..., : 6 * 5].reshape(got[0].shape), got[0])


_MASTER = np.random.RandomState(7).rand(2, 8, 1024, 2).astype(np.float32)


def _slot_stable_uniform(generator, shape):
    """Coordinates that depend only on (slot, point): the first n slots of a
    (b, n, s, 2) draw are the same for every n."""
    if len(shape) == 3:  # the matcher's (B, P, 2): no slot axis
        return torch.from_numpy(_MASTER[: shape[0], 0, : shape[1]].copy())
    b, n, s, _ = shape
    return torch.from_numpy(_MASTER[:b, :n, :s].copy())


def _raw_batch(seed=0, b=2, t=8, n_valid=(3, 2)):
    """Raw frames (uint8 RGB and depth, packed (b, HW, HW, 6)) with box targets
    padded to t, their bit-packed twin, and the stack the CPU builds of them."""
    rng = np.random.RandomState(seed)
    rgb = rng.randint(0, 256, (b, HW, HW, 3)).astype(np.uint8)
    depth = np.repeat(rng.randint(1, 256, (b, HW, HW, 1)).astype(np.uint8), 3, axis=-1)
    masks, classes, valid = _targets(rng, b, t, n_valid)
    packed = np.packbits(masks.astype(bool).reshape(b, t, -1), axis=-1)
    raw = np.concatenate([rgb, depth], axis=-1)
    pix = build_pixels("map_10channel_case2", torch.from_numpy(rgb), torch.from_numpy(depth),
                       PreprocessConfig(height=HW, width=HW)).numpy()
    return Batch(raw, masks, classes, valid, mask_labels_packed=packed), pix


def _tiny_model(seed=0):
    model = init_weights(Mask2FormerRGBD(ModelConfig.tiny(num_labels=NUM_LABELS, version="0.4.0")), seed)
    ratio = model.pixel_level_module.ratio_predictor
    ratio.dropout0.p = ratio.dropout1.p = 0.0
    return model


def test_compacted_packed_step_equals_padded_float_step(monkeypatch):
    """`put_batch` + `micro_step` of raw uint8 frames with bit-packed targets
    compacted from 8 slots to 4 against the float stack with float masks
    padded to 8: loss and every gradient equal within 1e-6."""
    monkeypatch.setattr(tlosses, "_uniform", _slot_stable_uniform)
    raw, pix = _raw_batch()
    pp = PreprocessConfig(height=HW, width=HW)
    runs = []
    for packed in (True, False):
        model = _tiny_model()
        args = targs.TrainingArguments(instance_bucket_floor=4, compact_instances=packed, pack_targets=packed)
        opt = make_optimizer(model, args, 4)
        batch = raw if packed else Batch(pix, raw.mask_labels, raw.class_labels, raw.valid)
        tb = put_batch(batch, args, "cpu")
        assert (tb.pixel_values.dtype, tb.mask_labels.dtype, tb.mask_labels.shape[1]) == (
            (torch.uint8, torch.uint8, 4) if packed else (torch.float32, torch.float32, 8))
        reset_launches()
        loss, _ = micro_step(model, opt, tb, torch.Generator().manual_seed(0), pp)
        assert set(LAUNCHES.values()) == {0}
        runs.append((loss.item(), {n: p.grad.clone() for n, p in model.named_parameters() if p.grad is not None}))
    (l_c, g_c), (l_p, g_p) = runs
    np.testing.assert_allclose(l_c, l_p, rtol=1e-6)
    assert set(g_c) == set(g_p)
    for n in g_p:
        scale = g_p[n].abs().max().item()
        assert (g_c[n] - g_p[n]).abs().max().item() <= 1e-6 * max(scale, 1e-30), n


# ---------------------------------------------------------------- accumulation


@pytest.fixture(scope="module")
def tiny_variables():
    cfg = JConfig.tiny(num_labels=NUM_LABELS, version="0.4.0")
    v = jax.jit(JModel(cfg).init)({"params": jax.random.PRNGKey(1)}, jnp.zeros((1, HW, HW, 10), jnp.float32))
    return cfg, jax.tree.map(lambda a: np.asarray(a).copy(), v)


@pytest.fixture
def same_points(monkeypatch):
    monkeypatch.setattr(jlosses, "_uniform", lambda rng, shape: jnp.asarray(_coords(shape)))
    monkeypatch.setattr(tlosses, "_uniform", lambda generator, shape: torch.from_numpy(_coords(shape)))
    monkeypatch.setattr(fnn.Dropout, "__call__", lambda self, x, *a, **k: x)


_JAX_STEPS = {}


def _cast(tree):
    """The JAX trainer's `_cast_bf16`: every float32 leaf to bfloat16."""
    return jax.tree.map(lambda a: a.astype(jnp.bfloat16) if a.dtype == jnp.float32 else a, tree)


def _jax_grads(cfg, params, batch_stats, x, masks, classes, valid, bf16=False):
    """(loss, grads, new batch stats) of the JAX train-mode forward and criterion;
    with `bf16`, through the JAX trainer's `_cast_bf16` policy. One jitted
    function per policy for the module's tests."""
    if bf16 not in _JAX_STEPS:
        cast = _cast if bf16 else (lambda t: t)

        def loss_fn(p, bs, x, masks, classes, valid):
            out, mut = JModel(cfg).apply({"params": cast(p), "batch_stats": bs}, cast(x), deterministic=False,
                                         mutable=["batch_stats"],
                                         rngs={"dropout": jax.random.PRNGKey(1), "droppath": jax.random.PRNGKey(2)})
            out = jax.tree.map(lambda a: a.astype(jnp.float32), out)
            total, _ = jlosses.mask2former_loss(cfg, out, masks, classes, valid, jax.random.PRNGKey(3))
            return total, mut["batch_stats"]

        _JAX_STEPS[bf16] = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    (loss, stats), grads = _JAX_STEPS[bf16](params, batch_stats, *(jnp.asarray(a) for a in (x, masks, classes, valid)))
    return float(loss), grads, stats


def _port_model(v, bf16=False):
    model = Mask2FormerRGBD(ModelConfig.tiny(num_labels=NUM_LABELS, version="0.4.0"))
    model.load_state_dict(from_flax(v["params"], v["batch_stats"]), strict=True)
    ratio = model.pixel_level_module.ratio_predictor
    ratio.dropout0.p = ratio.dropout1.p = 0.0
    return model.train()


def test_two_accumulated_micro_batches_and_apply_equal_jax(tiny_variables, same_points):
    """micro_step x 2 + apply_step(count=2) against the JAX accumulation: grads
    summed (the batch stats carried from the first micro-batch to the second),
    divided by the count, then the optax chain. A third micro-batch alone (an
    epoch's remainder) divides by 1 and equals `train_step`."""
    cfg, v = tiny_variables
    args = targs.TrainingArguments(learning_rate=1e-4, weight_decay=0.05, gradient_accumulation_steps=2,
                                   per_device_train_batch_size=2)
    batches = [(_frames(s), *_targets(np.random.RandomState(10 + s))) for s in (2, 3)]

    accum, stats = None, v["batch_stats"]
    for x, m, c, val in batches:
        _, g, stats = _jax_grads(cfg, v["params"], stats, x, m, c, val)
        accum = g if accum is None else jax.jit(lambda a, b: jax.tree.map(jnp.add, a, b))(accum, g)
    tx = _optax_chain(args, 4)

    @jax.jit
    def apply(accum, params):  # `_apply_step_fn` with count 2
        grads = jax.tree.map(lambda a: a / jnp.float32(2), accum)
        updates, _ = tx.update(grads, tx.init(params), params)
        return optax.apply_updates(params, updates), optax.global_norm(grads)

    j_params, j_norm = apply(accum, v["params"])

    model = _port_model(v)
    opt = make_optimizer(model, args, 8)  # 4 micro-batches of 2, 2 per step: 2 steps... as the JAX total below
    opt.schedule = _optax_chain_schedule(args, 4)
    gen = torch.Generator().manual_seed(0)
    for x, m, c, val in batches:
        micro_step(model, opt, _batch(x, m, c, val), gen)
    norm = apply_step(opt, 2)
    np.testing.assert_allclose(norm.item(), float(j_norm), rtol=1e-4)
    assert all(p.grad is None for p in model.parameters())
    got = _flat(to_flax({n: p.detach() for n, p in model.named_parameters()})[0])
    ref = _flat(jax.device_get(j_params))
    assert set(got) == set(ref)
    worst = max(np.abs(got[k] - ref[k]).max() for k in ref)
    assert worst <= 1e-5, worst
    new_stats = _flat(to_flax({n: b for n, b in model.state_dict().items() if "running" in n})[1])
    for k, r in _flat(jax.device_get(stats)).items():
        np.testing.assert_allclose(new_stats[k], r, atol=1e-5, rtol=1e-5, err_msg=k)

    # the remainder: one micro-batch, count 1, is the fused step
    x, m, c, val = batches[0]
    twins = [_port_model(v) for _ in range(2)]
    opts = [make_optimizer(t, args, 8) for t in twins]
    micro_step(twins[0], opts[0], _batch(x, m, c, val), torch.Generator().manual_seed(0))
    n0 = apply_step(opts[0], 1)
    _, _, n1 = train_step(twins[1], opts[1], _batch(x, m, c, val), torch.Generator().manual_seed(0))
    assert n0.item() == n1.item()
    for a, b in zip(twins[0].parameters(), twins[1].parameters()):
        assert torch.equal(a, b)


def _optax_chain_schedule(args, total_steps):
    from rgbdseg_torch.train.optim import linear_schedule

    return linear_schedule(args.learning_rate, total_steps, args.warmup_ratio)


def _batch(x, masks, classes, valid):
    from rgbdseg_torch.train.trainer import TrainBatch

    return TrainBatch(*(torch.from_numpy(np.asarray(a)) for a in (x, masks, classes, valid)))


# ---------------------------------------------------------------- bf16 policy


def _jax_dtypes(cfg, v, x, train: bool) -> dict:
    """Each JAX module's output dtype under `_cast_bf16`, by abstract evaluation."""
    variables = {"params": _cast(v["params"]), "batch_stats": v.get("batch_stats", {})}
    kw = dict(rngs={"dropout": jax.random.PRNGKey(1), "droppath": jax.random.PRNGKey(2)}) if train else {}
    _, state = jax.eval_shape(
        lambda variables, x: JModel(cfg).apply(
            variables, x, deterministic=not train, capture_intermediates=True,
            mutable=["intermediates", "batch_stats"] if train else ["intermediates"], **kw),
        variables, _cast(jnp.asarray(x)))
    out = {}

    def walk(tree, path):
        for k, val in tree.items():
            if k == "__call__":
                o = val[0]
                while isinstance(o, (tuple, list)):
                    o = o[0]
                out[".".join(path)] = str(o.dtype)
            elif isinstance(val, dict):
                walk(val, path + [k])

    walk(state["intermediates"], [])
    return out


def assert_bf16_module_dtypes_equal_jax(cfg, v, model, x, train: bool) -> dict:
    """Under the bf16 policy every module of the port returns the dtype the JAX
    module of the same name returns (`cfg`, `v`: the JAX model and its
    variables; `model`: the port's, with them loaded)."""
    ref = _jax_dtypes(cfg, v, x, train)
    model = model.train(train)
    got = {}

    def hook(name):
        def fn(module, inputs, output):
            while isinstance(output, (tuple, list)):
                output = output[0]
            got[name] = str(output.dtype).replace("torch.", "")
        return fn

    for name, m in model.named_modules():
        if name:
            m.register_forward_hook(hook(name))
    with torch.no_grad():
        forward(model, torch.from_numpy(x), torch.Generator().manual_seed(0), bf16=True)
    # The port applies Swin's query/key/value as one fused product (as the JAX
    # package computes them) without calling the modules; flax names dropout
    # layers by position.
    skip = (".attention.query", ".attention.key", ".attention.value", "Dropout_")
    compared = [k for k in ref if k and not any(s in k for s in skip)]
    assert len(compared) > 100
    assert {k: got.get(k) for k in compared} == {k: ref[k] for k in compared}
    return ref


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_bf16_module_dtypes_equal_jax(tiny_variables, monkeypatch, train):
    """Under the bf16 policy every module of the port returns the dtype the JAX
    module of the same name returns: where flax promotes a float32 input
    meeting bfloat16 parameters, where BatchNorm returns float32 (train) or
    its folded convolution's dtype (eval)."""
    cfg, v = tiny_variables
    monkeypatch.setattr(fnn.Dropout, "__call__", lambda self, x, *a, **k: x)
    ref = assert_bf16_module_dtypes_equal_jax(cfg, v, _port_model(v), _frames(4), train)
    if train:  # BatchNorm returns float32 in train mode, and flax computes the rest of E-DSAM in it
        assert {"float32", "bfloat16"} <= set(ref.values())


def test_bf16_step_matches_jax_cast_policy(tiny_variables, same_points):
    """One train-mode forward and backward under the bf16 policy against the
    JAX package's `_cast_bf16` path, and both against their float32 step:
    the loss and the master gradients' norm (see the module docstring); the
    gradients are float32, and the BN running statistics stay float32."""
    cfg, v = tiny_variables
    x = _frames()
    masks, classes, valid = _targets(np.random.RandomState(8))
    res = {}
    for bf16 in (False, True):
        j_loss, j_grads, _ = _jax_grads(cfg, v["params"], v["batch_stats"], x, masks, classes, valid, bf16)
        model = _port_model(v)
        args = targs.TrainingArguments(bf16=bf16)
        opt = make_optimizer(model, args, 2)
        loss, _ = micro_step(model, opt, _batch(x, masks, classes, valid), torch.Generator().manual_seed(0))
        grads = [p.grad for p in model.parameters() if p.grad is not None]
        assert all(g.dtype == torch.float32 for g in grads)
        assert all(b.dtype == torch.float32 for n, b in model.named_buffers() if "running" in n)
        res[bf16] = (loss.item(), global_norm(grads).item(), j_loss, _tree_norm(_flat(jax.device_get(j_grads))))
    for i, tol in ((0, 1e-2), (1, 2e-2)):  # loss, gradient norm
        port_bf16, jax_bf16, jax_f32 = res[True][i], res[True][i + 2], res[False][i + 2]
        gap = abs(port_bf16 - jax_bf16) / abs(jax_bf16)
        assert gap <= tol, (i, gap)
        assert gap < abs(jax_bf16 - jax_f32) / abs(jax_f32), (i, gap)
    np.testing.assert_allclose(res[False][0], res[False][2], rtol=1e-5)


def test_bf16_eval_forward_matches_jax(tiny_variables):
    """Eval mode under the bf16 policy: class and mask logits within 0.2 of
    the JAX bf16 forward's largest |logit| (measured 0.119), and less than
    half as far from it as it is from the float32 forward (measured 0.58).
    Eval mode parts more than train mode because the JAX package folds
    BatchNorm into the convolution before it there, rounding the scaled
    kernel to bfloat16, while the port normalises the convolution's bfloat16
    output in float32: E-DSAM's ratio then differs at the bfloat16 level and
    moves DSAM's window edges."""
    cfg, v = tiny_variables
    x = _frames(5)
    outs = {}
    for bf16 in (False, True):
        c = _cast if bf16 else (lambda t: t)
        o = jax.jit(lambda p, bs, x: JModel(cfg).apply({"params": p, "batch_stats": bs}, x, deterministic=True))(
            c(v["params"]), v["batch_stats"], c(jnp.asarray(x)))
        outs[bf16] = [np.asarray(o.class_queries_logits, np.float32), np.asarray(o.masks_queries_logits, np.float32)]
    model = _port_model(v).eval()
    with torch.no_grad():
        t = forward(model, torch.from_numpy(x), bf16=True)
    for got, ref, f32 in zip((t.class_queries_logits.numpy(), t.masks_queries_logits.numpy()), outs[True], outs[False]):
        scale = np.abs(ref).max()
        err = np.abs(got - ref).max() / scale
        assert err <= 0.2 and err < 0.5 * np.abs(ref - f32).max() / scale, err
