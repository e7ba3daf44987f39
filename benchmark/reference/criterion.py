"""The reference criterion (the port's `ops/losses.py` and `ops/matcher.py` on
one process): every prediction layer matched by scipy's Hungarian solver on
point-sampled costs, then scored by cross-entropy with a 0.1 no-object weight
and by the mask BCE and dice on importance-sampled points. The draws come from
the caller's generator in the port's order (all layers' matcher points, then
each layer's oversampled and uniform points), so that the reference samples
the points the port sampled; the matcher's points and the uncertainty pass run
without a gradient, and the masks' gradient flows through `F.grid_sample`.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from scipy.optimize import linear_sum_assignment

from . import ops
from .config import Config


def _sample_shared(masks, coords):
    """masks (B, N, H, W) at points (B, P, 2) shared by all masks -> (B, N, P)."""
    grid = (2.0 * coords.to(masks.device, masks.dtype) - 1.0)[:, None]
    return F.grid_sample(masks, grid, mode="bilinear", padding_mode="zeros", align_corners=False)[:, :, 0]


def _bce(logits, labels):
    return torch.clamp(logits, min=0) - logits * labels + torch.log1p(torch.exp(-logits.abs()))


def pairwise_mask_costs(pred_pts, tgt_pts):
    p = pred_pts.shape[-1]
    ce_pos = _bce(pred_pts, torch.ones_like(pred_pts)) / p
    ce_neg = _bce(pred_pts, torch.zeros_like(pred_pts)) / p
    tgt_t = tgt_pts.transpose(-1, -2)
    bce = ce_pos @ tgt_t + ce_neg @ (1.0 - tgt_t)
    probs = torch.sigmoid(pred_pts)
    dice = 1.0 - (2.0 * (probs @ tgt_t) + 1.0) / (probs.sum(-1)[..., :, None] + tgt_pts.sum(-1)[..., None, :] + 1.0)
    return bce, dice


@torch.no_grad()
def match_cost(cfg: Config, class_logits, mask_logits, target_masks, target_classes, target_valid, gen):
    """One layer's assignment cost (B, T, Q), rows the targets."""
    b, q = class_logits.shape[:2]
    probs = torch.softmax(class_logits, dim=-1)
    cls = target_classes.clamp(0, cfg.num_labels).long()
    cost_class = -torch.gather(probs, 2, cls[:, None, :].expand(b, q, -1))
    coords = ops.uniform(gen, (b, cfg.train_num_points, 2))
    bce, dice = pairwise_mask_costs(_sample_shared(mask_logits, coords), _sample_shared(target_masks, coords))
    cost = cfg.mask_weight * bce + cfg.class_weight * cost_class + cfg.dice_weight * dice
    cost = torch.nan_to_num(cost.clamp(-1e10, 1e10), nan=0.0)
    return torch.where(target_valid[:, None, :], cost, 0.0).transpose(1, 2)


def hungarian(cost: torch.Tensor) -> torch.Tensor:
    """(..., R, C) -> (..., R) the column of each row, scipy's minimum assignment."""
    host = cost.detach().to("cpu", torch.float32).numpy()
    flat = host.reshape(-1, *host.shape[-2:])
    col4row = np.empty(flat.shape[:2], np.int64)
    for i, c in enumerate(flat):
        rows, cols = linear_sum_assignment(c)
        col4row[i, rows] = cols
    return torch.from_numpy(col4row.reshape(host.shape[:-1])).to(cost.device)


@torch.no_grad()
def uncertain_points(cfg: Config, pred_masks, gen):
    """Oversampled uniform points, the least |logit| kept (ascending stable
    sort), uniform ones added: (B, N, P, 2)."""
    b, n = pred_masks.shape[:2]
    p = cfg.train_num_points
    num_uncertain = int(cfg.importance_sample_ratio * p)
    coords = ops.uniform(gen, (b, n, int(p * cfg.oversample_ratio), 2)).to(pred_masks.device)
    logits = ops.point_sample(pred_masks, coords)
    idx = torch.sort(logits.abs(), dim=-1, stable=True).indices[..., :num_uncertain]
    picked = torch.gather(coords, 2, idx[..., None].expand(-1, -1, -1, 2))
    if p - num_uncertain > 0:
        picked = torch.cat([picked, ops.uniform(gen, (b, n, p - num_uncertain, 2)).to(picked.device)], dim=2)
    return picked


def layer_losses(cfg: Config, class_logits, mask_logits, target_masks, target_classes, target_valid, gen, num_masks,
                 col4row):
    b, q = class_logits.shape[:2]
    rows = torch.arange(b, device=class_logits.device)[:, None]
    pred_m = mask_logits[rows, col4row]
    coords = uncertain_points(cfg, pred_m.detach(), gen)
    point_logits = ops.point_sample(pred_m, coords)
    with torch.no_grad():
        point_labels = ops.point_sample(target_masks, coords)
    validf = target_valid.float()
    loss_mask = (_bce(point_logits, point_labels).mean(-1) * validf).sum() / num_masks
    probs = torch.sigmoid(point_logits)
    dice = 1.0 - (2.0 * (probs * point_labels).sum(-1) + 1.0) / (probs.sum(-1) + point_labels.sum(-1) + 1.0)
    loss_dice = (dice * validf).sum() / num_masks
    tgt_q = torch.full((b, q), cfg.num_labels, dtype=torch.long, device=class_logits.device)
    tgt_q[rows, col4row] = torch.where(target_valid, target_classes.long(), cfg.num_labels)
    nll = -torch.gather(torch.log_softmax(class_logits, dim=-1), 2, tgt_q[..., None])[..., 0]
    wvec = torch.ones(cfg.num_labels + 1, device=class_logits.device)
    wvec[-1] = cfg.no_object_weight
    wy = wvec[tgt_q]
    loss_ce = (wy * nll).sum() / wy.sum()
    return cfg.class_weight * loss_ce + cfg.mask_weight * loss_mask + cfg.dice_weight * loss_dice


def mask2former_loss(cfg: Config, classes, masks, target_masks, target_classes, target_valid, gen) -> torch.Tensor:
    """The total loss over every layer (`classes`, `masks`: per layer, the final last)."""
    num_masks = target_valid.float().sum().clamp(min=1.0)
    target_masks = target_masks.float()
    costs = torch.stack([match_cost(cfg, c, m, target_masks, target_classes, target_valid, gen)
                         for c, m in zip(classes, masks)])
    total = torch.zeros((), device=classes[0].device)
    for c, m, c4r in zip(classes, masks, hungarian(costs)):
        total = total + layer_losses(cfg, c, m, target_masks, target_classes, target_valid, gen, num_masks, c4r)
    return total
