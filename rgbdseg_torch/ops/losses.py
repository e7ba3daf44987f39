"""Mask2Former criterion: Hungarian matching, point-sampled mask and dice
losses, cross-entropy (counterpart of `rgbdseg_tpu/ops/losses.py`).

Same semantics as the JAX criterion and the upstream HF `Mask2FormerLoss` it
mirrors: weights class 2.0 / mask 5.0 / dice 5.0, no-object 0.1,
`train_num_points` points, oversample 3.0, importance 0.75; every prediction
layer is matched and scored, the auxiliary ones first. Targets are padded to a
fixed T with a validity mask; padding rows enter the assignment with a uniform
cost of 0, which cannot change the real rows' assignment, and add no loss.

Where the port differs from the JAX package, and why:
- All layers' cost matrices go to the host in one copy and scipy solves them
  (`ops.matcher`), as the upstream criterion does.
- Each mask's own points (`sample_each_mask`, the counterpart of the JAX
  `_sample_each_mask`) are sampled by `ops.kernels.point_sample`: on the card
  a hand kernel whose gradient to the masks is summed in a fixed order, so a
  train step repeats bit for bit, as the JAX package's tent products do; on
  the CPU `F.grid_sample(align_corners=False, zeros)`. The gradient reaches
  the masks only (the coordinates are drawn without one). The matcher's
  points, shared by all masks and sampled without a gradient, stay
  `F.grid_sample`, whose forward repeats.
- Coordinates come from a `torch.Generator` through `_uniform`, which tests
  replace to feed both criteria the same points.
- Under data parallelism (`parallel.mesh.active`) each rank scores its own
  rows: the coordinates are drawn for the global batch and the rank keeps its
  rows, and the denominators (`num_masks`, the class weights' sum) are summed
  over the data group, so the ranks' losses add up to the global batch's loss
  (the JAX SPMD program's).
The criterion runs in float32 whatever the model's dtype.

Mask logits are (B, Q, H, W); target masks (B, T, H, W) float 0/1.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..config import ModelConfig
from ..parallel.mesh import data_sum, global_draw
from ..utils.trace import span
from .kernels.point_sample import point_sample
from .matcher import hungarian_batch

LOSS_KEYS = ("loss_cross_entropy", "loss_mask", "loss_dice")


def _uniform(generator: torch.Generator, shape: tuple) -> torch.Tensor:
    """Point-coordinate draw in [0, 1) of a batch-first shape (for the global
    batch under data parallelism, this rank's rows kept). An indirection, so
    that tests can inject the same coordinates into this criterion and the JAX
    package's."""
    return global_draw(lambda s: torch.rand(s, generator=generator, device=generator.device), shape)


def _sample_masks_at_points(masks: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """masks (B, N, H, W), coords (B, P, 2) (x, y) in [0, 1] shared by all masks -> (B, N, P)."""
    grid = (2.0 * coords.to(masks.device, masks.dtype) - 1.0)[:, None]
    return F.grid_sample(masks, grid, mode="bilinear", padding_mode="zeros", align_corners=False)[:, :, 0]


def sample_each_mask(masks: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """masks (B, N, H, W), coords (B, N, P, 2) (x, y) in [0, 1], one set per mask -> (B, N, P).
    Differentiable in the masks only."""
    return point_sample(masks, coords)


def _bce_with_logits(logits, labels):
    # log(1 + exp(-|x|)) + max(x, 0) - x * y
    return torch.clamp(logits, min=0) - logits * labels + torch.log1p(torch.exp(-logits.abs()))


def pairwise_mask_costs(pred_pts: torch.Tensor, tgt_pts: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """pred_pts (..., Q, P) logits, tgt_pts (..., T, P) in [0, 1] -> (bce (..., Q, T), dice (..., Q, T))."""
    p = pred_pts.shape[-1]
    ce_pos = _bce_with_logits(pred_pts, torch.ones_like(pred_pts)) / p
    ce_neg = _bce_with_logits(pred_pts, torch.zeros_like(pred_pts)) / p
    tgt_t = tgt_pts.transpose(-1, -2)
    bce = ce_pos @ tgt_t + ce_neg @ (1.0 - tgt_t)
    probs = torch.sigmoid(pred_pts)
    numer = 2.0 * (probs @ tgt_t)
    denom = probs.sum(-1)[..., :, None] + tgt_pts.sum(-1)[..., None, :]
    dice = 1.0 - (numer + 1.0) / (denom + 1.0)
    return bce, dice


@torch.no_grad()
def match_cost(cfg: ModelConfig, class_logits, mask_logits, target_masks, target_classes, target_valid,
               generator) -> torch.Tensor:
    """The assignment cost of one layer, (B, T, Q): rows are the targets."""
    b, q = class_logits.shape[:2]
    probs = torch.softmax(class_logits, dim=-1)
    safe_cls = target_classes.clamp(0, cfg.num_labels).long()
    cost_class = -torch.gather(probs, 2, safe_cls[:, None, :].expand(b, q, -1))  # (B, Q, T)
    coords = _uniform(generator, (b, cfg.train_num_points, 2))
    pred_pts = _sample_masks_at_points(mask_logits, coords)
    tgt_pts = _sample_masks_at_points(target_masks, coords)
    bce, dice = pairwise_mask_costs(pred_pts, tgt_pts)
    cost = cfg.mask_weight * bce + cfg.class_weight * cost_class + cfg.dice_weight * dice
    cost = torch.nan_to_num(cost.clamp(-1e10, 1e10), nan=0.0)
    cost = torch.where(target_valid[:, None, :], cost, 0.0)
    return cost.transpose(1, 2)


@torch.no_grad()
def sample_points_with_uncertainty(cfg: ModelConfig, pred_masks: torch.Tensor, generator) -> torch.Tensor:
    """Oversample, then keep the points of least |logit| and add uniform ones:
    pred_masks (B, N, H, W) logits -> coords (B, N, P, 2). The selection is an
    ascending stable sort on |logits|, the JAX package's tie order."""
    b, n = pred_masks.shape[:2]
    num_points = cfg.train_num_points
    num_sampled = int(num_points * cfg.oversample_ratio)
    num_uncertain = int(cfg.importance_sample_ratio * num_points)
    num_random = num_points - num_uncertain
    coords = _uniform(generator, (b, n, num_sampled, 2)).to(pred_masks.device)
    logits = sample_each_mask(pred_masks, coords)
    idx = torch.sort(logits.abs(), dim=-1, stable=True).indices[..., :num_uncertain]
    picked = torch.gather(coords, 2, idx[..., None].expand(-1, -1, -1, 2))
    if num_random > 0:
        picked = torch.cat([picked, _uniform(generator, (b, n, num_random, 2)).to(picked.device)], dim=2)
    return picked


def layer_losses(cfg: ModelConfig, class_logits, mask_logits, target_masks, target_classes, target_valid,
                 generator, num_masks, col4row) -> dict[str, torch.Tensor]:
    """Losses of one prediction layer, unweighted, for its assignment col4row
    (B, T): the query of each target slot."""
    b, q = class_logits.shape[:2]
    rows = torch.arange(b, device=class_logits.device)[:, None]
    pred_m = mask_logits[rows, col4row]  # (B, T, Hm, Wm)
    coords = sample_points_with_uncertainty(cfg, pred_m.detach(), generator)
    point_logits = sample_each_mask(pred_m, coords)
    with torch.no_grad():
        point_labels = sample_each_mask(target_masks, coords)

    validf = target_valid.float()
    ce = _bce_with_logits(point_logits, point_labels).mean(-1)
    loss_mask = (ce * validf).sum() / num_masks
    probs = torch.sigmoid(point_logits)
    numer = 2.0 * (probs * point_labels).sum(-1)
    denom = probs.sum(-1) + point_labels.sum(-1)
    dice = 1.0 - (numer + 1.0) / (denom + 1.0)
    loss_dice = (dice * validf).sum() / num_masks

    tgt_q = torch.full((b, q), cfg.num_labels, dtype=torch.long, device=class_logits.device)
    tgt_q[rows, col4row] = torch.where(target_valid, target_classes.long(), cfg.num_labels)
    nll = -torch.gather(torch.log_softmax(class_logits, dim=-1), 2, tgt_q[..., None])[..., 0]
    wvec = torch.ones(cfg.num_labels + 1, device=class_logits.device)
    wvec[-1] = cfg.no_object_weight
    wy = wvec[tgt_q]
    loss_ce = (wy * nll).sum() / data_sum(wy.sum())
    return {"loss_cross_entropy": loss_ce, "loss_mask": loss_mask, "loss_dice": loss_dice}


@span("criterion")
def mask2former_loss(cfg: ModelConfig, outputs, target_masks, target_classes, target_valid, generator):
    """The full criterion: (total, per-layer losses). The per-layer dict maps each
    loss to a (num_layers,) tensor, ordered [aux_0 ... aux_{L-2}, final] and
    already scaled by its weight. Every layer is matched before any is scored,
    with one device-to-host copy of all cost matrices. Under data parallelism
    the total is this rank's share of the global batch's loss."""
    num_masks = data_sum(target_valid.float().sum()).clamp(min=1.0)
    all_cls = list(outputs.aux_class_logits) + [outputs.class_queries_logits]
    all_msk = list(outputs.aux_mask_logits) + [outputs.masks_queries_logits]
    if not cfg.use_auxiliary_loss:
        all_cls, all_msk = all_cls[-1:], all_msk[-1:]
    all_cls = [c.float() for c in all_cls]
    all_msk = [m.float() for m in all_msk]
    target_masks = target_masks.float()
    costs = torch.stack([
        match_cost(cfg, c, m, target_masks, target_classes, target_valid, generator)
        for c, m in zip(all_cls, all_msk)
    ])
    col4rows = hungarian_batch(costs)  # (num_layers, B, T)
    weights = {"loss_cross_entropy": cfg.class_weight, "loss_mask": cfg.mask_weight, "loss_dice": cfg.dice_weight}
    total = torch.zeros((), device=all_cls[0].device)
    per_layer = {k: [] for k in LOSS_KEYS}
    for c, m, c4r in zip(all_cls, all_msk, col4rows):
        ld = layer_losses(cfg, c, m, target_masks, target_classes, target_valid, generator, num_masks, c4r)
        weighted = {k: ld[k] * weights[k] for k in LOSS_KEYS}
        total = total + (weighted["loss_cross_entropy"] + weighted["loss_mask"] + weighted["loss_dice"])
        for k in LOSS_KEYS:
            per_layer[k].append(weighted[k])
    return total, {k: torch.stack(v) for k, v in per_layer.items()}
