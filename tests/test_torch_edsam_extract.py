"""E-DSAM's extract stage (`ops/kernels/edsam_extract.py`): the wrapper's CPU
route against the composition it replaces, the pool's bins against torch's
adaptive pooling, the data-parallel statistics, the registry and the backward
that raises; and, on the card (`cuda`-marked, skipped without one), the
kernels against cuDNN's float32 composition and a float64 CPU reference.

The card's cases run at batch 2, 480 x 640 (the 16-byte loads) and at 37 x 45
(odd rows, a width that is no multiple of 4: the 4-byte loads and partial
tiles), in train and eval mode. The kernel's error against float64 must be no
more than twice cuDNN float32's (both sum 1152 float32 products per output in
other orders; 3xTF32 drops the lo*lo term, below float32's rounding), on the
pooled output, the batch mean and variance (read from the running statistics
at momentum 1) and the running statistics at momentum 0.1; an error under 4
float32 ulps of the quantity's largest magnitude (2**-21 relative) passes
whatever cuDNN's is, so that a cuDNN error of 0 asks for no exact result. Two
launches give the same bits. Run them on the card with
`python -m pytest --noconftest tests/test_torch_edsam_extract.py -m cuda`.
"""

import copy

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from rgbdseg_torch.models.fusion import EnhancedDepthImageRatioPredictor
from rgbdseg_torch.models.layers import BatchNorm2d, Conv2d
from rgbdseg_torch.ops import kernels
from rgbdseg_torch.ops.kernels import LAUNCHES, reset_launches
from rgbdseg_torch.ops.kernels import edsam_extract as KE
from rgbdseg_torch.ops.resize import adaptive_avg_pool2d

ULP_FLOOR = 2.0**-21  # 4 float32 ulps, relative
NAMES = ("edsam_extract", "edsam_extract_stats", "edsam_extract_apply")


def _stage(seed, momentum=0.1):
    """The stage's conv and BatchNorm with seeded weights and running statistics."""
    torch.manual_seed(seed)
    conv, bn = Conv2d(128, 256, 3, padding=1), BatchNorm2d(256, eps=1e-5, momentum=momentum)
    with torch.no_grad():
        bn.weight.copy_(1 + 0.1 * torch.randn(256))
        bn.bias.copy_(0.1 * torch.randn(256))
        bn.running_mean.copy_(0.1 * torch.randn(256))
        bn.running_var.copy_(1 + torch.rand(256))
    return conv, bn


def _input(seed, b, h, w):
    """Non-negative like the stage's input (ReLU output times a sigmoid gate), so y has a large mean."""
    rng = np.random.RandomState(seed)
    return torch.from_numpy(np.maximum(rng.randn(b, 128, h, w), 0).astype(np.float32)
                            * rng.rand(b, 128, h, w).astype(np.float32))


def _composition(x, conv, bn):
    """The composition the module ran before the stage was one design (fusion.py)."""
    y = F.relu(bn(conv(x)))
    return adaptive_avg_pool2d(y.permute(0, 2, 3, 1), (4, 4)).permute(0, 3, 1, 2)


@pytest.mark.parametrize("training", [True, False])
def test_cpu_route_is_the_composition_bit_for_bit(training):
    conv, bn = _stage(0)
    conv2, bn2 = copy.deepcopy(conv), copy.deepcopy(bn)
    bn.train(training)
    bn2.train(training)
    x = _input(1, 2, 7, 9)
    reset_launches()
    with torch.no_grad():
        got, want = KE.edsam_extract(x, conv, bn), _composition(x, conv2, bn2)
    assert torch.equal(got, want) and got.stride() == want.stride()
    for name in ("running_mean", "running_var", "num_batches_tracked"):
        assert torch.equal(getattr(bn, name), getattr(bn2, name)), name
    assert int(bn.num_batches_tracked) == int(training)
    assert set(LAUNCHES.values()) == {0}


def test_module_routes_the_stage_through_the_wrapper(monkeypatch):
    """E-DSAM's forward reaches the stage through `edsam_extract` with its own conv and BatchNorm."""
    from rgbdseg_torch.models import fusion

    mod = EnhancedDepthImageRatioPredictor().eval()
    seen = []

    def spy(x, conv, bn):
        seen.append((tuple(x.shape), conv is mod.extract_conv0, bn is mod.extract_bn0))
        return KE.edsam_extract(x, conv, bn)

    monkeypatch.setattr(fusion, "edsam_extract", spy)
    with torch.no_grad():
        out = mod(torch.rand(2, 12, 10, 3))
    assert seen == [((2, 128, 12, 10), True, True)] and out.shape == (2, 1)


@pytest.mark.parametrize("hw", [(480, 640), (720, 1280), (30, 40), (7, 9)])
def test_pool_bins_are_torchs(hw):
    h, w = hw
    x = torch.from_numpy(np.random.RandomState(h + w).randn(1, 3, h, w))  # float64: the sums' order hardly shows
    want = F.adaptive_avg_pool2d(x, (4, 4))
    got = torch.stack([torch.stack([x[..., r0:r1, c0:c1].mean(dim=(-2, -1)) for c0, c1 in KE.pool_bounds(w)], -1)
                       for r0, r1 in KE.pool_bounds(h)], -2)
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)


def test_data_parallel_statistics_are_the_global_batchs(monkeypatch):
    """`_global_moments` over two ranks (the all_reduce played by the test) gives
    the (count, mean, M2) of the two ranks' values taken together, the moments
    that `layers.BatchNorm2d._forward_global` reduces; the apply kernel then
    finalizes them as it does in one process (`cuda` case below)."""
    rng = np.random.RandomState(2)
    ranks = [torch.from_numpy(rng.randn(256, n) * 3 + rng.randn(256, 1) * 5) for n in (300, 500)]
    moments = [torch.stack([torch.full((256,), float(v.shape[1]), dtype=torch.float64), v.mean(1),
                            ((v - v.mean(1, keepdim=True)) ** 2).sum(1)], 1) for v in ranks]
    n1, mean1, m2_1 = moments[1].unbind(1)
    calls = []

    def all_reduce(t, group=None):  # rank 0's view: add rank 1's part
        calls.append(group)
        if len(calls) == 1:
            t += torch.stack([n1, n1 * mean1])
        else:
            mu = (moments[0][:, 0] * moments[0][:, 1] + n1 * mean1) / (moments[0][:, 0] + n1)
            t += m2_1 + n1 * (mean1 - mu) ** 2

    monkeypatch.setattr(KE.dist, "all_reduce", all_reduce)
    got = KE._global_moments(moments[0], "group")
    both = torch.cat(ranks, 1)
    mean = both.mean(1)
    want = torch.stack([torch.full((256,), 800.0, dtype=torch.float64), mean,
                        ((both - mean[:, None]) ** 2).sum(1)], 1)
    assert calls == ["group", "group"] and got.shape == (256, 3) and got.is_contiguous()
    # float64 sums of the same values in two orders: a few float64 ulps apart
    torch.testing.assert_close(got, want, rtol=1e-12, atol=0)


def test_kernel_counts_the_flops_the_plain_route_shows():
    """`Trainer.total_flos` adds the kernels' `FLOPS` to what FlopCounterMode sees:
    the products launch records what the mode counts for the plain route's conv."""
    from torch.utils.flop_counter import FlopCounterMode

    conv, bn = _stage(10)
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        KE.edsam_extract_plain(_input(11, 2, 6, 10), conv, bn)
    assert counter.get_total_flops() == KE.products_flops(2, 6, 10)


def test_registry_and_backward():
    assert set(NAMES) <= set(LAUNCHES) and set(NAMES) <= set(kernels.FLOPS)
    assert {kernels._source(n) for n in NAMES} == {"edsam_extract"}
    with pytest.raises(RuntimeError, match="no backward kernel"):
        KE.EdsamExtract.backward(None, torch.ones(2, 256, 4, 4))


def test_launch_refuses_cpu_tensors():
    conv, bn = _stage(4)
    with pytest.raises(ValueError, match="CUDA"):
        KE.extract_cuda(_input(5, 1, 4, 4), conv.weight.detach(), conv.bias.detach(), bn.weight.detach(),
                        bn.bias.detach(), bn.running_mean, bn.running_var, bn.num_batches_tracked, 1e-5, 0.1, False)


# ---------------------------------------------------------------- on the card


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


CARD_SHAPES = [(2, 480, 640), (2, 37, 45)]
_REF = {}


def _reference64(shape):
    """The stage's float64 pre-BatchNorm output on the CPU (cached per shape), its inputs, and its module state."""
    if shape not in _REF:
        conv, bn = _stage(6)
        x = _input(7, *shape)
        with torch.no_grad():
            y = F.conv2d(x.double(), conv.weight.double(), conv.bias.double(), padding=1)
        _REF[shape] = (x, conv, bn, y)
    return _REF[shape]


def _bn64(y, bn, training, momentum):
    """(pooled output, batch mean, biased var, new running mean, new running var) in float64."""
    if training:
        mean, var = y.mean((0, 2, 3)), y.var((0, 2, 3), unbiased=False)
        n = y.numel() // y.shape[1]
        rm = (1 - momentum) * bn.running_mean.double() + momentum * mean
        rv = (1 - momentum) * bn.running_var.double() + momentum * var * n / (n - 1)
    else:
        mean, var = bn.running_mean.double(), bn.running_var.double()
        rm, rv = mean, var
    z = (y - mean[:, None, None]) / torch.sqrt(var[:, None, None] + bn.eps) * bn.weight.detach().double()[:, None, None] \
        + bn.bias.detach().double()[:, None, None]
    return F.adaptive_avg_pool2d(torch.relu(z), (4, 4)), mean, var, rm, rv


def _run(fn, x, conv, bn, training, momentum):
    """fn's pooled output and the running statistics it leaves, from a fresh copy of the module state."""
    bn = copy.deepcopy(bn).cuda().train(training)
    bn.momentum = momentum
    with torch.no_grad():
        out = fn(x.cuda(), copy.deepcopy(conv).cuda(), bn)
    torch.cuda.synchronize()
    return out.double().cpu(), bn.running_mean.double().cpu(), bn.running_var.double().cpu(), bn


def _rel(a, ref):
    return ((a - ref).abs().max() / ref.abs().max()).item()


def _within(name, kernel_err, cudnn_err):
    assert kernel_err <= max(2 * cudnn_err, ULP_FLOOR), f"{name}: kernel {kernel_err:.3g}, cuDNN {cudnn_err:.3g}"


@pytest.mark.cuda
@pytest.mark.parametrize("shape", CARD_SHAPES)
@pytest.mark.parametrize("training", [True, False])
def test_cuda_extract_against_cudnn_and_float64(shape, training):
    _need_cuda()
    x, conv, bn, y64 = _reference64(shape)
    for momentum in ((1.0, 0.1) if training else (0.1,)):
        out64, mean64, var64, rm64, rv64 = _bn64(y64, bn, training, momentum)
        reset_launches()
        k_out, k_rm, k_rv, k_bn = _run(KE.edsam_extract, x, conv, bn, training, momentum)
        assert {n: LAUNCHES[n] for n in NAMES} == dict(zip(NAMES, (1, 1, 1) if training else (1, 0, 0)))
        assert int(k_bn.num_batches_tracked) == int(training)
        c_out, c_rm, c_rv, _ = _run(KE.edsam_extract_plain, x, conv, bn, training, momentum)
        _within("pooled output", _rel(k_out, out64), _rel(c_out, out64))
        if not training:
            continue
        if momentum == 1.0:  # the running statistics are the batch mean and the unbiased variance
            n = y64.numel() // 256
            _within("batch mean", _rel(k_rm, mean64), _rel(c_rm, mean64))
            _within("batch variance", _rel(k_rv * (n - 1) / n, var64), _rel(c_rv * (n - 1) / n, var64))
        else:
            _within("running mean", _rel(k_rm, rm64), _rel(c_rm, rm64))
            _within("running variance", _rel(k_rv, rv64), _rel(c_rv, rv64))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", CARD_SHAPES)
@pytest.mark.parametrize("training", [True, False])
def test_cuda_extract_repeats_bit_for_bit(shape, training):
    _need_cuda()
    x, conv, bn, _ = _reference64(shape)
    a = _run(KE.edsam_extract, x, conv, bn, training, 0.1)
    b = _run(KE.edsam_extract, x, conv, bn, training, 0.1)
    for u, v in zip(a[:3], b[:3]):
        assert torch.equal(u, v)


@pytest.mark.cuda
def test_cuda_extract_refuses_what_it_does_not_take():
    _need_cuda()
    conv, bn = _stage(8)
    args = [t.detach().cuda() for t in (conv.weight, conv.bias, bn.weight, bn.bias, bn.running_mean,
                                        bn.running_var, bn.num_batches_tracked)]
    x = _input(9, 1, 8, 12).cuda()
    for bad, kind in ((x.bfloat16(), TypeError), (x.transpose(2, 3), ValueError), (x.cpu(), ValueError)):
        with pytest.raises(kind):
            KE.extract_cuda(bad, *args, 1e-5, 0.1, False)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", CARD_SHAPES)
def test_cuda_extract_data_parallel_is_the_global_batchs(shape, monkeypatch):
    """Two ranks of one image each, played in one process: rank 1's moments are
    caught from its own launch (an all_reduce that adds nothing, a group of
    one), then rank 0's launch, whose all_reduce adds them, must give rank 0's
    image of one launch over both images, and its running statistics. The
    tiles' float32 partials are the same (a tile lies in one image); only their
    float64 combination runs in another order, some 1e-16 apart, so the
    float32 results may differ by a rounding step: 4 ulps of the largest
    magnitude (ULP_FLOOR) bounds them."""
    _need_cuda()
    x, conv, bn, _ = _reference64(shape)
    caught = []

    def catch(t, group=None):
        caught.append(t.clone())

    def add_rank1(t, group=None):
        n1, s1 = caught[0]
        if len(caught) == 2:  # the counts and sums
            caught.append(t + caught[0])
            t += caught[0]
        else:  # rank 1's M2 about the global mean
            mu = caught[2][1] / caught[2][0]
            t += caught[1] + n1 * (s1 / n1 - mu) ** 2

    def run(xs, all_reduce, group):
        monkeypatch.setattr(KE.dist, "all_reduce", all_reduce)
        b = copy.deepcopy(bn).cuda().train(True)
        c = copy.deepcopy(conv).cuda()
        with torch.no_grad():
            out = KE.extract_cuda(xs.cuda().contiguous(), c.weight, c.bias, b.weight, b.bias, b.running_mean,
                                  b.running_var, b.num_batches_tracked, b.eps, b.momentum, True, group)
        return out.cpu(), b

    run(x[1:], catch, "group")
    out0, bn0 = run(x[:1], add_rank1, "group")
    whole, bn_whole = run(x, catch, None)
    assert len(caught) == 3 and int(bn0.num_batches_tracked) == 1
    for got, want in ((out0, whole[:1]), (bn0.running_mean, bn_whole.running_mean),
                      (bn0.running_var, bn_whole.running_var)):
        assert _rel(got.double().cpu(), want.double().cpu()) <= ULP_FLOOR
