"""What decides `correct`: the plain reference run on the inputs and weights
the benchmark handed the port, and the numbers that compare the two.

Train cells: the reference follows the port's first three steps from the same
weights, batches and generator seed (it works out again the channel stack,
the compaction, the dropout and drop-path masks, the sampled points and the
matching). The readings (`train_numbers`): `loss`, the widest relative gap of
the three steps' losses, and `loss1`, the first step's; `grad`, over the
leaves that count, the widest gap between the norms of the first gradient as
the optimizer gets it (the port's: its first moment after one step over
1 - beta1) and the reference's clipped gradient, against the reference's norm
of that leaf or of the median leaf, whichever is larger; `update`, the same of
the parameters' change over the three steps; `grad_median` and
`update_median`, the median leaf's gaps. A leaf counts where the reference's
first gradient is at least a thousandth of the median leaf's: a leaf without
gradient moves by round-off alone.

Eval cells: the reference computes each distinct batch's logits once (the
stream cycles a ring of batches), the statistics of every image of the
stream, the eval loss of every batch with the port's sequence of sampled
points, and the mAP over the stream in order (`eval_numbers`). It derives
each masked-attention layer's mask from the port's mask logits of the layer
before (the port's outputs, read only to judge them): a logit within the
kernels' rounding of 0 would otherwise block a key on one side and not on the
other, and the flip would spread through the later layers. The derivation is
the reference's own (resize and threshold), so a port that derives its masks
wrongly still reads apart; the first layer's logits come before any mask.

A cell's limits file (`limits/<workload>.json`) names the readings compared
and their limits; PERF.md gives the readings each limit was set from.
"""

from __future__ import annotations

import gc
import statistics

import numpy as np
import torch

from .reference import criterion, evaluation, lowp, optim
from .reference.model import Mask2Former, channel_stack, unpack_masks

LEAF_FLOOR = 1e-3  # a leaf counts where its reference gradient is at least this share of the median leaf's


def compact(packed, classes, valid, floor: int):
    """The port's target compaction, worked out again: the smallest power-of-two
    bucket (at least `floor`) covering the batch's most instances, valid slots
    moved first (a stable order) when one lies past the cut."""
    t = valid.shape[1]
    tb = max(1, int(floor))
    while tb < int(valid.sum(1).max(initial=0)):
        tb *= 2
    if tb >= t:
        return packed, classes, valid
    if valid[:, tb:].any():
        order = np.argsort(~valid, axis=1, kind="stable")
        packed = np.take_along_axis(packed, order[:, :, None], axis=1)
        classes = np.take_along_axis(classes, order, axis=1)
        valid = np.take_along_axis(valid, order, axis=1)
    return packed[:, :tb], classes[:, :tb], valid[:, :tb]


def _targets(batch, device, floor=None):
    packed, classes, valid = batch["packed"], batch["classes"], batch["valid"]
    if floor is not None:
        packed, classes, valid = compact(packed, classes, valid, floor)
    hw = batch["frames"].shape[1:3]
    return (unpack_masks(torch.from_numpy(np.ascontiguousarray(packed)).to(device), hw),
            torch.from_numpy(np.ascontiguousarray(classes)).to(device),
            torch.from_numpy(np.ascontiguousarray(valid)).to(device))


def _lowered(control):
    """The context of a control: None (the reference as it is), "tf32", or a lower dtype."""
    if control is None:
        return lowp.lowered(None)
    if control == "tf32":
        return lowp.tf32(True)
    return lowp.lowered(control)


def reference_model(cfg, state, device, train: bool):
    model = Mask2Former(cfg).to(device)
    model.load_state_dict(state)
    return model.train(train)


def reference_train(cfg, state, batches, seed, device, traffic, total_steps, control=None) -> dict:
    """The reference's first three steps: their losses, the per-leaf norms of
    the first clipped gradient and of the change over the three steps."""
    model = reference_model(cfg, state, device, True)
    opt = optim.AdamW(model.named_parameters(), traffic["learning_rate"], total_steps,
                      max_grad_norm=traffic.get("max_grad_norm", 1.0))
    gen = torch.Generator(device=device).manual_seed(int(seed))
    losses, grad = [], {}
    with _lowered(control):
        for i, b in enumerate(batches[:3]):
            pix = channel_stack(cfg.version, torch.from_numpy(b["frames"]).to(device))
            classes, masks = model(pix, gen)
            loss = criterion.mask2former_loss(cfg, classes, masks, *_targets(b, device, traffic["bucket_floor"]), gen)
            loss.backward()
            opt.step()
            losses.append(loss.item())
            if i == 0:
                grad = {n: torch.linalg.vector_norm(g).item() for n, g in opt.last_grads.items()}
            del classes, masks, loss
    change = {n: torch.linalg.vector_norm(p.detach() - state[n]).item() for n, p in model.named_parameters()}
    del model, opt
    gc.collect()
    return {"losses": losses, "grad": grad, "change": change}


def worst_leaves(prog: dict, ref: dict) -> dict:
    """For the look: the leaf with the widest gap of each leaf number, its gap
    and the reference's norm of it against the median leaf's; and the deciles
    of the first gradient's leaf gaps (`grad_deciles`)."""
    median = statistics.median(ref["grad"].values())
    counted = [n for n, g in ref["grad"].items() if g >= LEAF_FLOOR * median]
    out = {}
    for key in ("grad", "change"):
        gaps = dict(zip(counted, _leaf_gaps(prog[key], ref[key], counted)))
        worst = max(gaps, key=gaps.get)
        scale = statistics.median([ref[key][n] for n in counted])
        out[key] = (worst, gaps[worst], ref[key][worst] / scale)
        if key == "grad":
            out["grad_deciles"] = [float(x) for x in np.quantile(list(gaps.values()), np.linspace(0.1, 0.9, 9))]
    return out


def _leaf_gaps(prog: dict, ref: dict, counted) -> list:
    scale = statistics.median([ref[n] for n in counted])
    return [abs(prog[n] - ref[n]) / max(ref[n], scale) for n in counted]


def train_numbers(prog: dict, ref: dict) -> dict:
    """A train cell's readings (see the module docstring); `loss1` is the
    first step's alone, `*_median` the median leaf's gap."""
    median = statistics.median(ref["grad"].values())
    counted = [n for n, g in ref["grad"].items() if g >= LEAF_FLOOR * median]
    losses = [abs(p - r) / abs(r) for p, r in zip(prog["losses"], ref["losses"])]
    grad, update = _leaf_gaps(prog["grad"], ref["grad"], counted), _leaf_gaps(prog["change"], ref["change"], counted)
    return {"loss": max(losses), "loss1": losses[0], "grad": max(grad), "grad_median": statistics.median(grad),
            "update": max(update), "update_median": statistics.median(update)}


@torch.no_grad()
def reference_eval(cfg, state, ring, stream_len, seed, device, id2label, control=None, forced=None,
                   keep_layers=False) -> dict:
    """The reference over an eval stream of `stream_len` batches cycling
    `ring`: each ring batch's logits, each stream batch's per-image statistics
    and loss (the points drawn from `seed` in the port's order), the mAP.
    `forced` {ring index: the program's mask logits of every layer but the
    last}: the attention masks are derived from those (`Mask2Former`'s
    `forced`), so that a mask logit within rounding of 0 blocks the same keys
    on both sides. `keep_layers`: also return every layer's mask logits."""
    model = reference_model(cfg, state, device, False)
    logits, stats = [], []
    with _lowered(control):
        for r, b in enumerate(ring[:stream_len]):
            pix = channel_stack(cfg.version, torch.from_numpy(b["frames"]).to(device))
            classes, masks = model(pix, forced=None if forced is None else forced[r])
            logits.append((classes, masks))
            gt_masks, _, gt_valid = _targets(b, device)
            stats.append(evaluation.host_stats(evaluation.eval_stats(classes[-1], masks[-1], gt_masks, gt_valid)))
        gen = torch.Generator(device=device).manual_seed(int(seed))
        losses, rows = [], []
        for j in range(stream_len):
            b = ring[j % len(ring)]
            classes, masks = logits[j % len(ring)]
            losses.append(criterion.mask2former_loss(cfg, classes, masks, *_targets(b, device), gen).item())
            s = stats[j % len(ring)]
            rows += [tuple(x[i] for x in s) + (b["classes"][i], b["valid"][i]) for i in range(len(b["classes"]))]
    out = {"logits": [(c[-1], m[-1], c[0], m[0]) for c, m in logits], "stats": stats, "loss": float(np.mean(losses)),
           "map": evaluation.mean_average_precision(rows, id2label)}
    if keep_layers:
        out["layers"] = [m[:-1] for _, m in logits]
    del model, logits
    gc.collect()
    return out


def _per_image_median(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per image (first axis), the median |a - b| against b's largest magnitude."""
    d = (a.float() - b.float()).abs().reshape(a.shape[0], -1)
    return d.median(dim=1).values / b.float().abs().max().clamp(min=1e-30)


def _widest(a: torch.Tensor, b: torch.Tensor) -> float:
    return ((a.float() - b.float()).abs().max() / b.float().abs().max().clamp(min=1e-30)).item()


def eval_numbers(prog: dict, ref: dict, ring_len: int) -> dict:
    """An eval cell's readings. `prog`: "logits" {stream index: (class, mask,
    first layer's class, first layer's mask)}, "stats" (per stream batch, the
    port's host statistics), "loss", "map" (its mAP keys); `ref`: the
    reference forced by the port's masks (`reference_eval`). `logits0`: the
    widest gap of the first prediction layer's class and mask logits, against
    the reference's largest magnitude; `logits`: the widest per-image median
    gap of the final layer's; `logits_max`: their widest gap; `scores`: the
    widest per-image median gap of the sorted scores; `stats`: per image, the
    widest gap of the sorted scores and of the total detection area and
    intersection; `loss`, `map`."""
    logit0 = logit_med = logit_max = 0.0
    for j, (c, m, c0, m0) in prog["logits"].items():
        rc, rm, rc0, rm0 = ref["logits"][j % ring_len]
        logit0 = max(logit0, _widest(c0, rc0), _widest(m0, rm0))
        logit_med = max(logit_med, _per_image_median(c, rc).max().item(), _per_image_median(m, rm).max().item())
        logit_max = max(logit_max, _widest(c, rc), _widest(m, rm))
    if not prog["logits"]:
        logit0 = logit_med = logit_max = float("inf")
    stat_gap = score_med = 0.0
    for j, s in enumerate(prog["stats"]):
        r = ref["stats"][j % ring_len]
        for i in range(len(r[0])):
            ps, rs = np.sort(s[0][i])[::-1], np.sort(r[0][i])[::-1]
            top = max(rs.max(), 1e-30)
            score_med = max(score_med, float(np.median(np.abs(ps - rs)) / top))
            stat_gap = max(stat_gap, float(np.abs(ps - rs).max() / top),
                           abs(float(s[2][i].sum() - r[2][i].sum())) / max(float(r[2][i].sum()), 1.0),
                           abs(float(s[4][i].sum() - r[4][i].sum())) / max(float(r[4][i].sum()), 1.0))
    keys = sorted(set(prog["map"]) | set(ref["map"]))
    map_gap = max(abs(prog["map"].get(k, np.nan) - ref["map"].get(k, np.nan)) for k in keys)
    return {"logits0": logit0, "logits": logit_med, "logits_max": logit_max, "scores": score_med, "stats": stat_gap,
            "loss": abs(prog["loss"] - ref["loss"]) / abs(ref["loss"]),
            "map": float(map_gap) if np.isfinite(map_gap) else float("inf")}


def judge(numbers: dict, limits: dict) -> bool:
    """Every number that has a limit is finite and at or under it (no limit at all: not correct)."""
    return bool(limits) and all(k in numbers and np.isfinite(numbers[k]) and numbers[k] <= v
                                for k, v in limits.items())
