"""Train-mode randomness: drop path (stochastic depth) and dropout
(counterparts of `rgbdseg_tpu/models/swin.py::drop_path` and flax's
`nn.Dropout`, which the JAX package uses in the fusion modules).

Both draw their keep masks from an explicit `torch.Generator` that the caller
passes down the forward; the masks are drawn on the generator's device and
moved to the activations'. Both are the identity in eval mode and at rate 0.
The two frameworks' generators give different bits from one seed, so tests
compare semantics, not masks. Under data parallelism a mask is drawn for the
global batch and the rank keeps its rows (`parallel.mesh.global_draw`), so a
step over N ranks draws what one process draws over the whole batch.
"""

from __future__ import annotations

import torch
from torch import nn

from ..parallel.mesh import global_draw


def _keep_mask(shape, keep: float, generator: torch.Generator | None, device) -> torch.Tensor:
    if generator is None:
        raise ValueError("train mode with a non-zero drop rate needs a torch.Generator")
    draw = global_draw(lambda s: torch.rand(s, generator=generator, device=generator.device), shape)
    return (draw < keep).to(device)


def drop_path(x: torch.Tensor, rate: float, training: bool, generator: torch.Generator | None) -> torch.Tensor:
    """Per sample (first axis): keep the branch with probability 1 - rate and scale it by 1 / (1 - rate)."""
    if not training or rate == 0.0:
        return x
    keep = 1.0 - rate
    mask = _keep_mask((x.shape[0],) + (1,) * (x.dim() - 1), keep, generator, x.device)
    return x / keep * mask.to(x.dtype)


class Dropout(nn.Module):
    """Per element: keep with probability 1 - p and scale by 1 / (1 - p); `p` may be changed after construction."""

    def __init__(self, p: float):
        super().__init__()
        self.p = p

    def forward(self, x: torch.Tensor, generator: torch.Generator | None) -> torch.Tensor:
        if not self.training or self.p == 0.0:
            return x
        keep = 1.0 - self.p
        return torch.where(_keep_mask(x.shape, keep, generator, x.device), x / keep, torch.zeros_like(x))
