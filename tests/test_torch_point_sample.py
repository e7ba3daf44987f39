"""The criterion's point sampling (`ops.losses.sample_each_mask`, through
`ops.kernels.point_sample`) against the JAX package's `_sample_each_mask` and
its custom VJP, the plain versions of the CUDA kernel's lattice keys and
cell lists against brute force, and the ordered model of the backward
kernel's sum (`point_sample_bwd_ordered_plain`) against the JAX VJP, the
plain backward and the same order written out term by term, on spread and
bunched points (all of a mask's points in one lattice cell).

Inputs are drawn from numpy seeds; some points lie outside [0, 1), so the zero
padding is used. Tolerance for the JAX comparison: 1e-6 x the largest |value|
(the sampled values and the mask gradient): the two compute the same bilinear
weights by other float32 roundings (the JAX tent products from c * w - 0.5,
grid_sample from ((2c - 1 + 1) * w - 1) / 2) and sum them in another order.
The `cuda`-marked cases hold the CUDA kernels against the plain versions
(the forward bit for bit `F.grid_sample`, the backward bit for bit the
ordered model) and skip without a card. JAX is imported inside the `jx` fixture only, so that they
also run on a machine without JAX
(`python -m pytest --noconftest tests/test_torch_point_sample.py -m cuda`).
"""

import numpy as np
import pytest
import torch

from rgbdseg_torch.ops import losses
from rgbdseg_torch.ops.kernels import LAUNCHES, reset_launches
from rgbdseg_torch.ops.kernels import point_sample as KP

RTOL = 1e-6


@pytest.fixture
def jx():
    jax = pytest.importorskip("jax")
    from rgbdseg_tpu.ops.losses import _sample_each_mask

    return jax, _sample_each_mask


def _inputs(seed, b=1, n=3, h=8, w=10, p=64, lo=-0.1, hi=1.1):
    rng = np.random.RandomState(seed)
    masks = rng.randn(b, n, h, w).astype(np.float32)
    coords = rng.uniform(lo, hi, (b, n, p, 2)).astype(np.float32)
    cotangent = rng.randn(b, n, p).astype(np.float32)
    return masks, coords, cotangent


def _close(got, want, what):
    scale = np.abs(want).max()
    err = np.abs(got - want).max()
    assert err <= RTOL * scale, f"{what}: {err} > {RTOL} x {scale}"


@pytest.mark.parametrize("seed,shape", [(0, {}), (1, {"b": 2, "n": 2, "h": 9, "w": 7, "p": 50}),
                                        (2, {"lo": 0.0, "hi": 1.0})])
def test_forward_and_mask_gradient_equal_jax(jx, seed, shape):
    jax, jax_sample = jx
    masks, coords, cot = _inputs(seed, **shape)
    want, vjp = jax.vjp(jax_sample, masks, coords)
    want_dm = np.asarray(vjp(cot)[0])
    m = torch.from_numpy(masks).requires_grad_()
    got = losses.sample_each_mask(m, torch.from_numpy(coords))
    (got_dm,) = torch.autograd.grad(got, m, torch.from_numpy(cot))
    _close(got.detach().numpy(), np.asarray(want), "sampled values")
    _close(got_dm.numpy(), want_dm, "mask gradient")


def test_coords_get_no_gradient_in_either_package(jx):
    jax, jax_sample = jx
    masks, coords, cot = _inputs(3)
    _, vjp = jax.vjp(jax_sample, masks, coords)
    assert not np.asarray(vjp(cot)[1]).any()
    m, c = torch.from_numpy(masks).requires_grad_(), torch.from_numpy(coords).requires_grad_()
    out = losses.sample_each_mask(m, c)
    out.backward(torch.from_numpy(cot))
    assert c.grad is None and m.grad is not None and m.grad.abs().sum() > 0


def test_wrapper_on_cpu_is_the_plain_version_and_launches_nothing():
    masks, coords, cot = _inputs(4)
    m, c = torch.from_numpy(masks), torch.from_numpy(coords)
    reset_launches()
    assert torch.equal(KP.point_sample(m, c), KP.point_sample_plain(m, c))
    leaf = m.clone().requires_grad_()
    (grad,) = torch.autograd.grad(KP.point_sample(leaf, c), leaf, torch.from_numpy(cot))
    assert torch.equal(grad, KP.point_sample_plain_bwd(m, c, torch.from_numpy(cot)))
    assert set(LAUNCHES.values()) == {0}


@pytest.mark.parametrize("seed", range(2))
def test_lattice_keys_plain_hold_every_point_footprint(seed):
    """Each point's cells of non-zero weight (grid_sample's own gradient of a
    one-point sample) lie in the 2x2 footprint its key names; a point without a
    key touches no cell. Points at exact integer and half-integer pixel
    coordinates included."""
    h, w, p = 8, 10, 96
    rng = np.random.RandomState(seed)
    coords = rng.uniform(-0.2, 1.2, (1, p, 2)).astype(np.float32)
    coords[0, :16] = (rng.randint(-2, 12, (16, 2)) / np.array([w, h])).astype(np.float32)
    coords[0, 16:32] = ((rng.randint(-2, 12, (16, 2)) + 0.5) / np.array([w, h])).astype(np.float32)
    c = torch.from_numpy(coords)
    keys = KP.lattice_keys_plain(c[:, :, None], h, w)[0, :, 0]
    support = KP.point_sample_plain_bwd(torch.zeros(1, p, h, w), c[:, :, None], torch.ones(1, p, 1))[0] != 0
    for i in range(p):
        k = int(keys[i])
        cells = {(int(y), int(x)) for y, x in support[i].nonzero()}
        if k < 0:
            assert not cells, (i, coords[0, i], cells)
            continue
        y0, x0 = k // (w + 1) - 1, k % (w + 1) - 1
        assert cells <= {(y0 + dy, x0 + dx) for dy in (0, 1) for dx in (0, 1)}, (i, coords[0, i], k, cells)
    assert (keys >= 0).sum() > p // 2 and (keys < 0).any()


def test_cell_lists_plain_equal_brute_force():
    rng = np.random.RandomState(5)
    m, p, cells = 3, 40, 12
    keys = torch.from_numpy(rng.randint(-1, cells, (m, p)))
    keys[1, :20] = 4  # a long list
    starts, lists = KP.cell_lists_plain(keys, cells)
    assert starts.shape == (m, cells + 1)
    for i in range(m):
        for c in range(cells):
            want = [j for j in range(p) if keys[i, j] == c]
            assert lists[starts[i, c]:starts[i, c + 1]].tolist() == want
        assert starts[i, cells] == i * p + int((keys[i] >= 0).sum())


def _bunched(coords, h, w, seed):
    """Every point of every mask within the 2x2 footprint of lattice cell
    (4, 4): one list of P points per mask."""
    rng = np.random.RandomState(seed)
    return ((3 + rng.uniform(0.5, 1.5, coords.shape)) / np.array([w, h])).astype(np.float32)


def _ordered_scalar_loop(coords, cot, h, w):
    """The backward kernel's sum written out point by point in numpy float32
    scalars: per cell, its se, sw, ne and nw lists, each in ascending point
    order, each term (wx * wy) * g."""
    m = coords.shape[0] * coords.shape[1]
    c = torch.from_numpy(coords).reshape(m, -1, 2)
    src = KP.source_indices_plain(c, h, w).numpy()
    g = cot.reshape(m, -1)
    out = np.zeros((m, h, w), np.float32)
    for i in range(m):
        for y in range(h):
            for x in range(w):
                acc = np.float32(0)
                for dy, dx in ((1, 1), (1, 0), (0, 1), (0, 0)):  # this cell as se, sw, ne, nw corner
                    for p in range(src.shape[1]):
                        ix, iy = src[i, p]
                        x0, y0 = np.floor(ix), np.floor(iy)
                        if not (-1 <= x0 <= w - 1 and -1 <= y0 <= h - 1) or (y0 + dy, x0 + dx) != (y, x):
                            continue
                        wx = ix - x0 if dx else np.float32(x0 + 1) - ix
                        wy = iy - y0 if dy else np.float32(y0 + 1) - iy
                        acc = np.float32(acc + np.float32(np.float32(wx * wy) * g[i, p]))
                out[i, y, x] = acc
    return out.reshape(coords.shape[:2] + (h, w))


_ORDERED_CASES = [(0, {}, False), (1, {"b": 2, "n": 2, "h": 9, "w": 7, "p": 50}, False),
                  (2, {"lo": 0.0, "hi": 1.0}, False), (3, {}, True), (4, {"b": 2, "n": 2, "h": 9, "w": 7, "p": 50}, True)]


@pytest.mark.parametrize("seed,shape,bunched", _ORDERED_CASES)
def test_ordered_backward_model_equals_jax_and_plain(jx, seed, shape, bunched):
    """The ordered model of the backward kernel's sum against the JAX VJP and
    torch's autograd of `F.grid_sample`, within RTOL x max; bunched: all P
    points of a mask in one lattice cell, so one list of P terms."""
    jax, jax_sample = jx
    masks, coords, cot = _inputs(seed, **shape)
    h, w = masks.shape[2:]
    if bunched:
        coords = _bunched(coords, h, w, seed)
        keys = KP.lattice_keys_plain(torch.from_numpy(coords), h, w)
        assert (keys == keys.flatten()[0]).all() and keys.flatten()[0] >= 0
    _, vjp = jax.vjp(jax_sample, masks, coords)
    got = KP.point_sample_bwd_ordered_plain(torch.from_numpy(coords), torch.from_numpy(cot), h, w).numpy()
    _close(got, np.asarray(vjp(cot)[0]), "ordered model vs JAX")
    _close(got, KP.point_sample_plain_bwd(torch.from_numpy(masks), torch.from_numpy(coords),
                                          torch.from_numpy(cot)).numpy(), "ordered model vs plain")


@pytest.mark.parametrize("bunched", [False, True])
def test_ordered_backward_model_equals_a_scalar_loop(bunched):
    """The model's vectorised sum gives the bits of the same order written out
    term by term, with points on exact pixel centres and edges too."""
    masks, coords, cot = _inputs(7, n=2, h=6, w=7, p=40)
    if bunched:
        coords = _bunched(coords, 6, 7, 7)
    else:
        coords[0, 0, :8] = (np.arange(-1, 7) / 7.0).astype(np.float32)[:, None]
        coords[0, 1, :8] = ((np.arange(-1, 7) + 0.5) / 6.0).astype(np.float32)[:, None]
    got = KP.point_sample_bwd_ordered_plain(torch.from_numpy(coords), torch.from_numpy(cot), 6, 7).numpy()
    want = _ordered_scalar_loop(coords, cot, 6, 7)
    assert np.array_equal(got.view(np.int32), want.view(np.int32))
    assert np.abs(want).max() > 0


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")


def _cuda_inputs(seed, b=2, n=16, h=120, w=160, p=12544):
    masks, coords, cot = _inputs(seed, b, n, h, w, p)
    return (torch.from_numpy(a).cuda() for a in (masks, coords, cot))


@pytest.mark.cuda
@pytest.mark.parametrize("seed,p", [(0, 12544), (1, 37632)])
def test_cuda_point_sample_equals_plain(seed, p):
    _need_cuda()
    masks, coords, cot = _cuda_inputs(seed, p=p)
    reset_launches()
    got = KP.point_sample(masks, coords)
    want = KP.point_sample_plain(masks, coords)
    torch.cuda.synchronize()
    assert LAUNCHES["point_sample"] == 1
    torch.testing.assert_close(got, want, atol=RTOL * want.abs().max().item(), rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("seed", range(2))
def test_cuda_point_sample_backward_equals_plain_and_repeats(seed):
    _need_cuda()
    masks, coords, cot = _cuda_inputs(seed)
    leaf = masks.clone().requires_grad_()
    reset_launches()
    (got,) = torch.autograd.grad(KP.point_sample(leaf, coords), leaf, cot)
    assert (LAUNCHES["point_sample"], LAUNCHES["point_sample_bwd"]) == (1, 1)
    want = KP.point_sample_plain_bwd(masks, coords, cot)
    torch.testing.assert_close(got, want, atol=RTOL * want.abs().max().item(), rtol=0)
    assert torch.equal(got, KP._launch_bwd(coords, cot, *masks.shape[2:]))


@pytest.mark.cuda
def test_cuda_point_sample_lists_equal_plain():
    """The kernel's sum in the order of the plain lattice keys and cell lists
    (the ordered model built on them), bit for bit, on points bunched into a
    few cells as well as spread ones."""
    _need_cuda()
    masks, coords, cot = _cuda_inputs(2, b=1, n=4, h=30, w=40, p=3000)
    coords[:, :2, :1000] = coords[:, :2, :1000] * 0.02 + 0.5
    got = KP._launch_bwd(coords, cot, 30, 40)
    assert torch.equal(got, KP.point_sample_bwd_ordered_plain(coords, cot, 30, 40))


def _main_path_bunched(coords, seed):
    """The main path's geometry with bunched masks: mask 0's points all in one
    lattice cell (one list of P), mask 1's all in one 16-row band, mask 2's
    half in one cell; the rest as drawn."""
    rng = np.random.RandomState(seed)
    p = coords.shape[2]
    c = coords.clone()
    c[0, 0] = torch.from_numpy(((60 + rng.uniform(0.5, 1.5, (p, 2))) / np.array([160, 120])).astype(np.float32))
    c[0, 1, :, 1] = torch.from_numpy(rng.uniform(32 / 120, 48 / 120, p).astype(np.float32))
    c[0, 2, : p // 2] = torch.from_numpy(((20 + rng.uniform(0.5, 1.5, (p // 2, 2))) / 120).astype(np.float32))
    return c.to(coords.device)


@pytest.mark.cuda
@pytest.mark.parametrize("seed,case", [(0, "spread"), (1, "spread"), (2, "bunched"), (3, "misaligned")])
def test_cuda_point_sample_backward_equals_ordered_model(seed, case):
    """The backward kernel against the ordered model at the main path's
    geometry, bit for bit, and two launches with the same bits; bunched points
    included (the kernel's path for a band that overflows shared memory), and
    an odd P on coordinates 8 bytes past a 16-byte boundary (its path without
    vector loads)."""
    _need_cuda()
    masks, coords, cot = _cuda_inputs(seed, p=12543 if case == "misaligned" else 12544)
    if case == "bunched":
        coords = _main_path_bunched(coords, seed)
    if case == "misaligned":
        buf = torch.empty(coords.numel() + 2, device=coords.device)
        buf[2:].copy_(coords.reshape(-1))
        coords = buf[2:].view(coords.shape)
    got = KP._launch_bwd(coords, cot, 120, 160)
    assert torch.equal(got, KP.point_sample_bwd_ordered_plain(coords, cot, 120, 160))
    assert torch.equal(got, KP._launch_bwd(coords, cot, 120, 160))


@pytest.mark.cuda
@pytest.mark.parametrize("h,w,p,misaligned", [(120, 160, 37632, False), (120, 160, 12544, False),
                                              (480, 640, 12544, False), (120, 160, 12543, False),
                                              (30, 40, 1000, True)])
def test_cuda_point_sample_equals_grid_sample_bit_for_bit(h, w, p, misaligned):
    """The forward kernel gives `F.grid_sample`'s bits at the criterion's three
    samplings, and at an odd P and on coordinates 8 bytes past a 16-byte
    boundary (its path without vector loads)."""
    _need_cuda()
    masks, coords, _ = _cuda_inputs(3, h=h, w=w, p=p)
    if misaligned:
        buf = torch.empty(coords.numel() + 2, device=coords.device)
        buf[2:].copy_(coords.reshape(-1))
        coords = buf[2:].view(coords.shape)
    assert torch.equal(KP.point_sample(masks, coords), KP.point_sample_plain(masks, coords))
