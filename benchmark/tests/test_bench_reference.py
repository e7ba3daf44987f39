"""The frozen reference against the port at a tiny size on the CPU, from the
benchmark's weights and inputs: the channel stack, the logits of every layer
(eval and train mode, with the same dropout and drop-path draws), the loss of
three steps and the parameters after them."""

import json

import numpy as np
import pytest
import torch

from benchmark import check, harness, inputs
from benchmark.reference import criterion, optim
from benchmark.reference.config import Config
from benchmark.reference.model import Mask2Former, channel_stack, unpack_masks


def _pair(version, queries=20):
    from rgbdseg_torch.config import ModelConfig
    from rgbdseg_torch.models.mask2former import Mask2FormerRGBD

    pcfg = ModelConfig.tiny(num_labels=5, version=version).replace(num_queries=queries, train_num_points=64)
    rcfg = Config.from_dict(json.loads(pcfg.to_json()))
    state = harness._weights(rcfg, 2**31 + 3, "cpu")
    port = Mask2FormerRGBD(pcfg)
    port.load_state_dict(state)
    ref = Mask2Former(rcfg)
    ref.load_state_dict(state)
    return pcfg, rcfg, state, port, ref


@pytest.mark.parametrize("version", ["0.4.0", "0.0.0"])
@pytest.mark.parametrize("mode", ["eval", "train"])
def test_logits_equal_port(version, mode):
    from rgbdseg_torch.config import PreprocessConfig
    from rgbdseg_torch.data.device_preprocess import build_from_packed

    _, _, _, port, ref = _pair(version)
    b = inputs.batches(5, 1, 2, (64, 96), 8, [3, 4], 5, version == "0.4.0")[0]
    frames = torch.from_numpy(b["frames"])
    pix = build_from_packed("map_10channel_case2" if version == "0.4.0" else "map_3channel", frames,
                            PreprocessConfig(height=64, width=96))
    assert torch.equal(pix, channel_stack(version, frames))
    port.train(mode == "train")
    ref.train(mode == "train")
    out = port(pix, torch.Generator().manual_seed(7))
    classes, masks = ref(pix, torch.Generator().manual_seed(7))
    for got, want in zip(list(out.aux_class_logits) + [out.class_queries_logits], classes):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    for got, want in zip(list(out.aux_mask_logits) + [out.masks_queries_logits], masks):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("version", ["0.4.0", "0.0.0"])
def test_three_steps_equal_port(version):
    from rgbdseg_torch.config import PreprocessConfig
    from rgbdseg_torch.data.pipeline import Batch
    from rgbdseg_torch.train import trainer as T
    from rgbdseg_torch.train.arguments import TrainingArguments

    _, rcfg, state, port, ref = _pair(version)
    port.train()
    args = TrainingArguments(per_device_train_batch_size=2, learning_rate=1e-4, num_train_epochs=10)
    opt = T.make_optimizer(port, args, 100)
    ring = inputs.batches(9, 3, 2, (64, 96), 12, [5, 6, 7], 5, version == "0.4.0")
    gen = torch.Generator().manual_seed(11)
    losses, grad = [], {}
    for b in ring:
        tb = T.put_batch(Batch(b["frames"], b["masks"], b["classes"], b["valid"], mask_labels_packed=b["packed"]),
                         args, "cpu")
        losses.append(T.train_step(port, opt, tb, gen, PreprocessConfig(height=64, width=96))[0].item())
        if not grad:
            grad = {opt.names[p]: torch.linalg.vector_norm(st["mu"]).item() / 0.1 for p, st in opt.state.items()}
    change = {n: torch.linalg.vector_norm(p.detach() - state[n]).item() for n, p in port.named_parameters()}
    traffic = {"learning_rate": 1e-4, "bucket_floor": 8}
    ref_readings = check.reference_train(rcfg, state, ring, 11, "cpu", traffic, opt.total_steps)
    numbers = check.train_numbers({"losses": losses, "grad": grad, "change": change}, ref_readings)
    assert max(numbers.values()) < 1e-4, numbers


def test_compaction_is_the_ports():
    from rgbdseg_torch.data.pipeline import compact_targets

    rng = np.random.default_rng(0)
    for _ in range(20):
        valid = rng.random((3, 20)) < rng.random()
        packed = rng.integers(0, 255, (3, 20, 5), dtype=np.uint8)
        classes = rng.integers(0, 5, (3, 20))
        masks = np.zeros((3, 20, 2, 2), np.float32)
        want = compact_targets(masks, classes, valid, 8, packed=packed)
        got = check.compact(packed, classes, valid, 8)
        for g, w in zip(got, (want[3], want[1], want[2])):
            np.testing.assert_array_equal(g, w)


def test_criterion_and_optimizer_move_every_trained_leaf():
    """One reference step: a finite loss, and the leaves with a gradient move."""
    _, rcfg, state, _, ref = _pair("0.0.0")
    ref.train()
    b = inputs.batches(3, 1, 2, (64, 96), 12, [5, 6, 7], 5, False)[0]
    opt = optim.AdamW(ref.named_parameters(), 1e-3, 10)
    gen = torch.Generator().manual_seed(0)
    classes, masks = ref(channel_stack("0.0.0", torch.from_numpy(b["frames"])), gen)
    loss = criterion.mask2former_loss(rcfg, classes, masks, unpack_masks(torch.from_numpy(b["packed"]), (64, 96)),
                                      torch.from_numpy(b["classes"]), torch.from_numpy(b["valid"]), gen)
    loss.backward()
    opt.step()
    assert np.isfinite(loss.item())
    moved = [n for n, p in ref.named_parameters() if not torch.equal(p.detach(), state[n])]
    assert len(moved) >= 0.9 * len(list(ref.parameters()))


@pytest.mark.parametrize("shift", [0.0, 1.0])
def test_forced_masks_follow_the_given_layers(shift):
    """Forced by its own layers' mask logits, the reference reads as unforced;
    forced by shifted ones, its later layers move and its first does not."""
    _, rcfg, _, _, ref = _pair("0.4.0")
    ref.eval()
    b = inputs.batches(5, 1, 2, (64, 96), 12, [5, 6, 7], 5, True)[0]
    pix = channel_stack("0.4.0", torch.from_numpy(b["frames"]))
    with torch.no_grad():
        classes, masks = ref(pix)
        fc, fm = ref(pix, forced=[m + shift for m in masks[:-1]])
    assert torch.equal(fm[0], masks[0]) and torch.equal(fc[0], classes[0])
    assert torch.equal(fm[-1], masks[-1]) == (shift == 0.0)


def test_ulp_witness_moves_operands_by_one_bit():
    """`lowered(ULP)` clears the last mantissa bit of float32 operands, and
    the gradient passes through it unchanged."""
    from benchmark.reference import lowp

    x = torch.randn(7, 5, generator=torch.Generator().manual_seed(3)).t().requires_grad_()
    with lowp.lowered(lowp.ULP):
        y = lowp.q(x)
        assert lowp.q(x.double()).dtype == torch.float64
    assert bool(((y.detach().view(torch.int32) & 1) == 0).all())
    assert 0 < (y - x).abs().max().item() <= x.abs().max().item() * 2.0**-23
    y.sum().backward()
    assert torch.equal(x.grad, torch.ones_like(x))
