"""Hungarian assignment on the host (counterpart of `rgbdseg_tpu/ops/matcher.py`).

The JAX package solves the assignment on the device with `lax` while-loops, so
that the TPU step stays one XLA program. On the GPU those loops would be
thousands of tiny launches, so the port does what the upstream HF criterion
does (`linear_sum_assignment(cost_matrix.cpu())`, which the JAX criterion's
docstring cites): one device-to-host copy of every cost matrix of a step, then
`scipy.optimize.linear_sum_assignment` per matrix. The total cost is the same
as the JAX solver's; the argmin may differ only on exact ties.

Under a profiler the call is the span `matcher` (`utils/trace.py`), split into
`matcher.copy` (which waits for the device to finish the work queued before
it) and `matcher.solve`.
"""

from __future__ import annotations

import numpy as np
import torch
from scipy.optimize import linear_sum_assignment

from ..utils.trace import span


@span("matcher")
def hungarian_batch(cost: torch.Tensor) -> torch.Tensor:
    """(..., R, C) cost with R <= C (rows = padded targets, cols = queries) ->
    (..., R) int64 column per row, on the cost's device."""
    if cost.shape[-2] > cost.shape[-1]:
        raise ValueError(f"cost {tuple(cost.shape)}: more targets than queries")
    with span("matcher.copy"):
        host = cost.detach().to("cpu", torch.float32).numpy()
    with span("matcher.solve"):
        flat = host.reshape(-1, *host.shape[-2:])
        col4row = np.empty(flat.shape[:2], np.int64)
        for i, c in enumerate(flat):
            rows, cols = linear_sum_assignment(c)
            col4row[i, rows] = cols
    return torch.from_numpy(col4row.reshape(host.shape[:-1])).to(cost.device)
