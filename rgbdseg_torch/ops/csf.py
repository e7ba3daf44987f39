"""Cosine-Similarity Fuse (CSF) of N images (counterpart of
`rgbdseg_tpu/ops/csf.py`; reference `cosine_similarity_fuse_v3`,
data_process.py:755-919).

Round k (standard image k):
- the pixel-wise cosine similarity of image k with every image j != k (over
  the channel axis; both-zero pixels 1.0, one-zero pixels 0.0);
- per pixel, the source of the round is the first j of maximal similarity
  (the reference's strict `>` scan in increasing j), and the round image B_k
  takes that source's pixel;
- the source contributing the most pixels to the round (the first on ties)
  adds its pixel count to its score.
The scores normalised are the weights, uniform if all are 0, and the fused
image is the weighted sum of the round images. `csf_fuse` returns it in the
input's dtype, as the reference does: a uint8 input is truncated.
"""

from __future__ import annotations

import torch


def pixel_cosine_similarity(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pixel-wise cosine similarity of (..., H, W, C) images -> (..., H, W)."""
    a = a.to(torch.float64 if a.dtype == torch.float64 else torch.float32)
    b = b.to(a.dtype)
    dot = (a * b).sum(-1)
    na = torch.linalg.vector_norm(a, dim=-1)
    nb = torch.linalg.vector_norm(b, dim=-1)
    denom = na * nb
    sim = torch.where(denom != 0, dot / torch.where(denom == 0, torch.ones_like(denom), denom),
                      torch.zeros_like(denom))
    return torch.where((na == 0) & (nb == 0), torch.ones_like(sim), sim)


def _fma_chain(weights: torch.Tensor, round_images: torch.Tensor) -> torch.Tensor:
    """sum_k weights[k] * round_images[k] in float32 as the JAX package's einsum
    sums it on the CPU: fused multiply-adds in increasing k, each rounded once
    (a float32 product is exact in float64, so one float64 add and one
    rounding to float32 stand for the fma). The uint8 truncation of
    `csf_fuse` turns a last-bit difference into an integer."""
    w = weights.to(torch.float64)
    acc = (w[0] * round_images[0].to(torch.float64)).to(torch.float32)
    for k in range(1, weights.shape[0]):
        acc = (acc.to(torch.float64) + w[k] * round_images[k].to(torch.float64)).to(torch.float32)
    return acc


def csf_intermediates(images: torch.Tensor) -> dict:
    """CSF of (N, H, W, C) images with its intermediates: sim (N, N, H, W) with
    -inf on the diagonal, best (N, H, W) each round's source per pixel,
    round_images (N, H, W, C), counts (N, N) pixels per (round, source),
    scores (N,), weights (N,), fused (H, W, C) float32."""
    n, h, w, _ = images.shape
    imgs = images.to(torch.float32)
    sim = pixel_cosine_similarity(imgs[:, None], imgs[None, :])
    eye = torch.eye(n, dtype=torch.bool, device=imgs.device)[:, :, None, None]
    sim = torch.where(eye, torch.full_like(sim, float("-inf")), sim)
    best = torch.argmax(sim, dim=1)  # the first maximum, as the reference's scan
    rows = torch.arange(h, device=imgs.device)[:, None]
    cols = torch.arange(w, device=imgs.device)[None, :]
    round_images = imgs[best, rows, cols]
    counts = torch.nn.functional.one_hot(best, n).to(torch.float32).sum((1, 2))
    winner = torch.argmax(counts, dim=1)
    scores = torch.zeros(n, dtype=torch.float32, device=imgs.device).index_add_(0, winner, counts.amax(1))
    total = scores.sum()
    weights = torch.where(total == 0, torch.full_like(scores, 1.0 / n),
                          scores / torch.where(total == 0, torch.ones_like(total), total))
    fused = _fma_chain(weights, round_images)
    return {"sim": sim, "best": best, "round_images": round_images, "counts": counts, "scores": scores,
            "weights": weights, "fused": fused}


def csf_fuse(images: torch.Tensor) -> torch.Tensor:
    """Fuse (N, H, W, C) images -> (H, W, C) in the input's dtype."""
    if images.shape[0] <= 1:
        return images[0]
    return csf_intermediates(images)["fused"].to(images.dtype)
