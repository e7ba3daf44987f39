"""E-DSAM's full-resolution extract stage as one hand design: the 3x3 conv
from 128 to 256 channels, BatchNorm, ReLU and the adaptive average pool to
4 x 4 (`models/fusion.py::EnhancedDepthImageRatioPredictor`).

Not the counterpart of a TPU kernel: the JAX package runs this stage in XLA.
On the H100 it is the largest operation of every 0.4.0 step, a float32
convolution of 2.90 TFLOP at batch 16, 480 x 640, whose 5 GB output three more
kernels read again before the pool keeps 16 numbers of each plane. The CUDA
source (`rgbdseg_torch/csrc/edsam_extract.cu`) runs the products as an implicit
GEMM on the tensor cores in 3xTF32 (float32's accuracy: lo*hi + hi*lo + hi*hi
over TF32 halves, as `mma_tf32.cuh`), with `wgmma` from a producer warpgroup's
rings, and fuses the rest:

- train mode (`bn.training`): the products kernel stores y and each tile's
  per-channel mean and M2; `edsam_extract_stats` combines them in a fixed order
  into the batch's (count, mean, M2) in float64; `edsam_extract_apply`
  finalizes them (the running statistics and `num_batches_tracked` moved as
  `BatchNorm2d` moves them) and reads y once: normalise with the biased
  variance, affine, ReLU, the 4 x 4 bins. Three launches a step. Under data
  parallelism the moments are summed over the data group
  (`torch.distributed.all_reduce`, as `layers.BatchNorm2d`'s global batch)
  between the second and the third;
- eval mode: BatchNorm with the running statistics is a per-channel affine, so
  the products kernel applies it, the ReLU and the bin sums in its epilogue and
  never stores y. One launch.

Every sum runs in an order fixed by the shapes, so two launches give the same
bits. The bins are torch's adaptive pooling bins (`pool_bounds`), so uneven
sizes work. No gradient reaches this stage (0.4.0 uses the ratio only for the
depth windows' edges): the Function's backward raises.

`edsam_extract(x, conv, bn)`: x (B, 128, H, W) NCHW, `conv` the 3x3 Conv2d, `bn`
the BatchNorm2d; returns (B, 256, 4, 4). On a CPU tensor it is
`edsam_extract_plain`, the composition conv, BN, ReLU, pool, unchanged. On a
CUDA tensor the kernels get float32 operands: a bfloat16 input or weights (a
serving model cast whole to bfloat16) are promoted first, as `Conv2d` promotes
them, and the output comes back in the dtype the composition returns.
`extract_cuda` is the launch itself and takes float32 CUDA tensors only.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ...parallel.mesh import data_parallel
from ...utils.trace import span
from ..resize import adaptive_avg_pool2d
from . import check_cuda_tensor, launch

POOL = 4  # the pool's output size, each way
C_IN, C_OUT = 128, 256
TILE_ROWS, TILE_COLS = 2, 128  # the products kernel's pixel tile


def pool_bounds(size: int, out: int = POOL) -> list[tuple[int, int]]:
    """torch's adaptive pooling bins along one axis, as the kernels take them:
    [floor(i * size / out), ceil((i + 1) * size / out))."""
    return [(i * size // out, -(-(i + 1) * size // out)) for i in range(out)]


def edsam_extract_plain(x: torch.Tensor, conv, bn) -> torch.Tensor:
    """The plain version: the module's conv, BatchNorm (train or eval, its
    running statistics updated in train mode), ReLU and torch's adaptive average
    pool to 4 x 4, NCHW in and out."""
    y = F.relu(bn(conv(x)))
    return adaptive_avg_pool2d(y.permute(0, 2, 3, 1), (POOL, POOL)).permute(0, 3, 1, 2)


def products_flops(b: int, h: int, w: int) -> int:
    """The conv's dense operations, 2 x M x N x K, as torch's FlopCounterMode
    counts the convolution the plain version runs."""
    return 2 * b * h * w * C_OUT * C_IN * 9


def _tiles(b: int, h: int, w: int) -> int:
    return b * -(-h // TILE_ROWS) * -(-w // TILE_COLS)


def _check(t: torch.Tensor, name: str, shape) -> None:
    check_cuda_tensor(t, name, (torch.float32,))
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}; expected {tuple(shape)}")


def _global_moments(moments: torch.Tensor, group) -> torch.Tensor:
    """A data-parallel step's (count, mean, M2) per channel, float64 (256, 3):
    the local ones summed over the group exactly (the global mean from the
    counts and sums, then each rank's M2 about it)."""
    n, mean, m2 = moments.unbind(1)
    sums = torch.stack([n, n * mean])
    dist.all_reduce(sums, group=group)
    mu = sums[1] / sums[0]
    m2 = m2 + n * (mean - mu) ** 2
    dist.all_reduce(m2, group=group)
    return torch.stack([sums[0], mu, m2], dim=1).contiguous()


def extract_cuda(x, weight, bias, gamma, beta, running_mean, running_var, tracked, eps: float, momentum: float,
                 training: bool, group=None) -> torch.Tensor:
    """The kernels: (B, 256, 4, 4) float32 from float32 CUDA tensors x (B, 128,
    H, W), weight (256, 128, 3, 3), bias, gamma, beta and the running statistics
    (256,); `tracked` the int64 `num_batches_tracked`. In train mode the
    running statistics and `tracked` are updated in place; `group`: the data
    group whose global batch the statistics cover."""
    check_cuda_tensor(x, "x", (torch.float32,))
    if x.dim() != 4 or x.shape[1] != C_IN:
        raise ValueError(f"x has shape {tuple(x.shape)}; expected (B, {C_IN}, H, W)")
    _check(weight, "weight", (C_OUT, C_IN, 3, 3))
    for name, t in (("bias", bias), ("gamma", gamma), ("beta", beta), ("running_mean", running_mean),
                    ("running_var", running_var)):
        _check(t, name, (C_OUT,))
    b, _, h, w = x.shape
    out = torch.empty(b, C_OUT, POOL, POOL, dtype=torch.float32, device=x.device)
    if b * h * w == 0:
        return out
    tiles = _tiles(b, h, w)
    wt = torch.empty(2, 144, 2, 1024, dtype=torch.float32, device=x.device)  # the weights split, per k8 step
    flops = products_flops(b, h, w)
    common = (x.data_ptr(), weight.data_ptr(), wt.data_ptr(), bias.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
              running_mean.data_ptr(), running_var.data_ptr(), float(eps))
    if not training:
        tile_rows = b * -(-h // TILE_ROWS)
        rows = torch.empty(tiles, 2, C_OUT, POOL, dtype=torch.float32, device=x.device)
        rowsums = torch.empty(tile_rows, 2, C_OUT, POOL, dtype=torch.float32, device=x.device)
        counters = torch.zeros(tile_rows + b * POOL, dtype=torch.int32, device=x.device)
        launch("edsam_extract", *common, None, None, rows.data_ptr(), rowsums.data_ptr(), counters.data_ptr(),
               out.data_ptr(), b, h, w, 1, flops=flops)
        return out
    if b * h * w < 2:
        raise ValueError("BatchNorm in train mode needs more than one value per channel")
    if tracked.dtype != torch.int64 or tracked.device != x.device:
        raise TypeError("num_batches_tracked must be an int64 tensor on x's device")
    y = torch.empty(b, C_OUT, h, w, dtype=torch.float32, device=x.device)
    stats = torch.empty(C_OUT, tiles, 2, dtype=torch.float32, device=x.device)
    launch("edsam_extract", *common, y.data_ptr(), stats.data_ptr(), None, None, None, None, b, h, w, 0,
           flops=flops)
    moments = torch.empty(C_OUT, 3, dtype=torch.float64, device=x.device)
    launch("edsam_extract_stats", stats.data_ptr(), moments.data_ptr(), b, h, w)
    if group is not None:
        moments = _global_moments(moments, group)
    launch("edsam_extract_apply", y.data_ptr(), moments.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
           running_mean.data_ptr(), running_var.data_ptr(), tracked.data_ptr(), out.data_ptr(), b, h, w,
           float(momentum), float(eps))
    return out


class EdsamExtract(torch.autograd.Function):
    """The kernels in the autograd graph; no gradient flows back through them."""

    @staticmethod
    def forward(ctx, x, weight, bias, gamma, beta, running_mean, running_var, tracked, eps, momentum, training,
                group):
        return extract_cuda(x, weight, bias, gamma, beta, running_mean, running_var, tracked, eps, momentum,
                            training, group)

    @staticmethod
    def backward(ctx, grad):
        raise RuntimeError("E-DSAM's extract stage has no backward kernel: no gradient reaches the ratio "
                           "predictor in 0.4.0, whose ratio only sets the depth windows' edges")


def _f32(t: torch.Tensor) -> torch.Tensor:
    return t.float().contiguous()


@span("op.edsam_extract")
def edsam_extract(x: torch.Tensor, conv, bn) -> torch.Tensor:
    """The wrapper: the plain version for CPU tensors, the kernels for CUDA ones
    (train or eval mode by `bn.training`; under data parallelism in train mode,
    the data group's global batch)."""
    if not x.is_cuda:
        return edsam_extract_plain(x, conv, bn)
    if bn.momentum is None or not (bn.affine and bn.track_running_stats):
        raise ValueError("the kernels take an affine BatchNorm with running statistics and a momentum")
    dt = torch.promote_types(torch.promote_types(x.dtype, conv.weight.dtype), conv.bias.dtype)
    group = None
    if bn.training:  # the running statistics are updated in place
        mesh = data_parallel()
        group = mesh.data_group if mesh is not None else None
        stats = (bn.running_mean, bn.running_var)
        dt = torch.promote_types(torch.promote_types(dt, bn.weight.dtype), torch.float32)
    else:
        stats = (_f32(bn.running_mean), _f32(bn.running_var))
    out = EdsamExtract.apply(_f32(x), _f32(conv.weight), _f32(conv.bias), _f32(bn.weight), _f32(bn.bias), *stats,
                             bn.num_batches_tracked, bn.eps, bn.momentum, bn.training, group)
    return out.to(dt)
