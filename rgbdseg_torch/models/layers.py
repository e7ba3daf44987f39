"""The port's layers with flax's dtype rules, for the bf16 policy
(`train/trainer.py::forward`: a bfloat16 copy of the parameters and the input).

torch raises where operands of two float dtypes meet in a product; flax
promotes them (`flax.linen.dtypes.promote_dtype`). So:
- `Linear` and `Conv2d` compute in the promoted dtype of input, weight and
  bias: a float32 input meeting bfloat16 parameters runs in float32;
- `LayerNorm` and `GroupNorm` take their statistics and normalise in float32
  and return the promoted dtype of input, scale and bias;
- `BatchNorm2d` computes in float32 as the JAX package's `TorchBatchNorm`
  (`rgbdseg_tpu/models/fusion.py:52-88`). In train mode it returns, as that
  module does, the promoted dtype of input, parameters and running statistics,
  which stay float32: float32 under the bf16 policy. In eval mode the JAX
  package folds each BatchNorm into the convolution before it
  (`fusion.py::_conv_bn_relu`, `EnhancedDepthImageRatioPredictor`), so the
  normalised output keeps the convolution's dtype: here, the input's;
- `promote(*tensors)` casts operands of a product to their promoted dtype.

Under data parallelism (a mesh of data width above 1 active,
`parallel.mesh.active`) `BatchNorm2d` in train mode takes its statistics over
the global batch: the per-channel sum and count, then the sum of squared
deviations, summed over the data group with gradient
(`torch.distributed.nn.functional.all_reduce`); it normalises with the global
mean and biased variance and moves its running variance by the unbiased
global one, as `TorchBatchNorm` does. `torch.nn.SyncBatchNorm` would do the
same on CUDA tensors only.

Where the dtypes already agree (every layer in float32), each is torch's own
layer, bit for bit, behind one dtype comparison. All the port's layers have
an affine weight and a bias of the weight's dtype.
"""

from __future__ import annotations

import functools

import torch
import torch.distributed.nn.functional as dist_nn
import torch.nn.functional as F
from torch import nn

from ..parallel.mesh import data_parallel


def promoted(*tensors) -> torch.dtype:
    return functools.reduce(torch.promote_types, (t.dtype for t in tensors if t is not None))


def promote(*tensors):
    dt = promoted(*tensors)
    return tuple(None if t is None else t.to(dt) for t in tensors)


class Linear(nn.Linear):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dtype == self.weight.dtype:  # the bias has the weight's dtype
            return F.linear(x, self.weight, self.bias)
        return F.linear(*promote(x, self.weight, self.bias))


class Conv2d(nn.Conv2d):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dtype == self.weight.dtype:
            return self._conv_forward(x, self.weight, self.bias)
        return self._conv_forward(*promote(x, self.weight, self.bias))


def _f32(t):
    return None if t is None else t.float()


class LayerNorm(nn.LayerNorm):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dtype == self.weight.dtype == torch.float32:
            return super().forward(x)
        dt = promoted(x, self.weight, self.bias)
        return F.layer_norm(x.float(), self.normalized_shape, _f32(self.weight), _f32(self.bias), self.eps).to(dt)


class GroupNorm(nn.GroupNorm):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dtype == self.weight.dtype == torch.float32:
            return super().forward(x)
        dt = promoted(x, self.weight, self.bias)
        return F.group_norm(x.float(), self.num_groups, _f32(self.weight), _f32(self.bias), self.eps).to(dt)


class BatchNorm2d(nn.BatchNorm2d):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mesh = data_parallel() if self.training else None
        if mesh is not None:
            return self._forward_global(x, mesh.data_group)
        if x.dtype == self.weight.dtype == torch.float32:
            return super().forward(x)
        dt = promoted(x, self.weight, self.bias, self.running_mean, self.running_var) if self.training else x.dtype
        if self.training:
            self.num_batches_tracked.add_(1)
        w, b = _f32(self.weight), _f32(self.bias)
        return F.batch_norm(x.float(), self.running_mean, self.running_var, w, b, self.training,
                            self.momentum, self.eps).to(dt)

    def _forward_global(self, x: torch.Tensor, group) -> torch.Tensor:
        """Train mode over the data group's global batch (float32, as the
        single-process path)."""
        dt = promoted(x, self.weight, self.bias, self.running_mean, self.running_var)
        xf = x.float()
        per_channel = (None, slice(None), None, None)
        sums = dist_nn.all_reduce(torch.cat([xf.sum((0, 2, 3)), xf.new_full((1,), xf.numel() / xf.shape[1])]),
                                  group=group)
        n = sums[-1]
        mean = sums[:-1] / n
        xc = xf - mean[per_channel]
        var = dist_nn.all_reduce((xc * xc).sum((0, 2, 3)), group=group) / n
        out = xc * torch.rsqrt(var + self.eps)[per_channel] * _f32(self.weight)[per_channel] \
            + _f32(self.bias)[per_channel]
        with torch.no_grad():
            m = self.momentum
            self.running_mean.mul_(1 - m).add_(mean.detach() * m)
            self.running_var.mul_(1 - m).add_(var.detach() * (n / (n - 1)) * m)
            self.num_batches_tracked.add_(1)
        return out.to(dt)
