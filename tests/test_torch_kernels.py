"""The port's kernel modules against the JAX package's golden twins.

The plain PyTorch versions of K1 (`deform_sample_level` for one level,
`deform_sample_levels` for all levels of an encoder layer) and K3
(`masked_cross_attention`) are held against `tent_sample_level_xla` (summed
over levels for the multi-level function) and `masked_cross_attention_xla`,
which `tests/test_pallas_kernels.py` pins to the Pallas kernels. The CUDA
kernels themselves are held against the plain versions by the `cuda`-marked
tests, which need a card and skip without one. JAX is imported inside the `jx`
fixture only, so that the CUDA tests also run on a machine without JAX
(`python -m pytest --noconftest tests/test_torch_kernels.py -m cuda`).
"""

import numpy as np
import pytest
import torch

from rgbdseg_torch.ops.kernels import LAUNCHES, reset_launches
from rgbdseg_torch.models.pixel_decoder import initial_locations, reference_points_for_shapes, sampling_locations
from rgbdseg_torch.ops.kernels.deformable import (
    deform_sample_level,
    deform_sample_level_plain,
    deform_sample_level_plain_bwd,
    deform_sample_levels,
    deform_sample_levels_plain,
    deform_sample_levels_plain_bwd,
)
from rgbdseg_torch.ops.kernels import deformable as _deform
from rgbdseg_torch.ops.kernels import masked_attention as _mca
from rgbdseg_torch.ops.kernels.masked_attention import (
    masked_cross_attention,
    masked_cross_attention_plain,
    masked_cross_attention_plain_bwd,
)


@pytest.fixture
def jx():
    jax = pytest.importorskip("jax")
    from rgbdseg_tpu.ops.kernels import deformable, masked_attention

    return jax, deformable, masked_attention


def _softmax(x):
    e = np.exp(x - x.max(-1, keepdims=True))
    return e / e.sum(-1, keepdims=True)


def _tent_inputs(bh=2, l=300, npts=4, h=17, w=23, hd=32, seed=0):
    """The inputs of `test_pallas_kernels._tent_inputs`: coords span out of bounds."""
    rng = np.random.RandomState(seed)
    gx = rng.uniform(-2.0, w + 2.0, (bh, l, npts)).astype(np.float32)
    gy = rng.uniform(-2.0, h + 2.0, (bh, l, npts)).astype(np.float32)
    aw = _softmax(rng.randn(bh, l, npts).astype(np.float32))
    v = rng.randn(bh, h * w, hd).astype(np.float32)
    return gx, gy, aw, v


def _tent_model_shape(bh=2, npts=4, h=60, w=80, hd=32, seed=3):
    """The 480x640 level-0 geometry of `TestTentBandKernel`: raster-ordered local queries."""
    rng = np.random.RandomState(seed)
    l = h * w
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    gx = (xx.reshape(-1)[None, :, None] + rng.uniform(-3, 3, (bh, l, npts))).astype(np.float32)
    gy = (yy.reshape(-1)[None, :, None] + rng.uniform(-3, 3, (bh, l, npts))).astype(np.float32)
    aw = _softmax(rng.randn(bh, l, npts).astype(np.float32))
    v = rng.randn(bh, h * w, hd).astype(np.float32)
    return gx, gy, aw, v


def _tent_integer_coords(bh=2, l=200, npts=4, h=9, w=11, hd=16, seed=5):
    """Exact-integer coordinates, including the borders -1, 0, w-1 and w."""
    rng = np.random.RandomState(seed)
    gx = rng.randint(-1, w + 1, (bh, l, npts)).astype(np.float32)
    gy = rng.randint(-1, h + 1, (bh, l, npts)).astype(np.float32)
    aw = _softmax(rng.randn(bh, l, npts).astype(np.float32))
    v = rng.randn(bh, h * w, hd).astype(np.float32)
    return gx, gy, aw, v


_DEFORM_CASES = {
    "out_of_bounds_17x23": (lambda: _tent_inputs(), 17, 23),
    "l1337_30x40": (lambda: _tent_inputs(l=1337, h=30, w=40), 30, 40),
    "integer_coords_9x11": (lambda: _tent_integer_coords(), 9, 11),
    "model_shape_60x80": (lambda: _tent_model_shape(), 60, 80),
}


@pytest.mark.parametrize("case", sorted(_DEFORM_CASES))
def test_deform_plain_matches_jax_twin(jx, case):
    """Tolerance 1e-5: the same f32 bilinear weights summed in another order."""
    _, deformable, _ = jx
    make, h, w = _DEFORM_CASES[case]
    gx, gy, aw, v = make()
    ref = np.asarray(deformable.tent_sample_level_xla(gx, gy, aw, v, h, w))
    out = deform_sample_level_plain(*(torch.from_numpy(a) for a in (gx, gy, aw, v)), h, w)
    assert out.dtype == torch.float32 and out.shape == ref.shape
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5, rtol=1e-5)


def _levels_inputs(shapes, nh=2, hd=32, npts=4, b=2, geometry="random", seed=0):
    """Inputs of the multi-level K1 in the model's layouts, one query per pixel of
    every level (as in the encoder). "random": locations over [-0.1, 1.1]^2, out
    of bounds too; "model": the sampling locations of a freshly initialised layer
    (reference point plus 1..P pixels along each head's direction)."""
    rng = np.random.RandomState(seed)
    nl = len(shapes)
    l = sum(h * w for h, w in shapes)
    value = rng.randn(b, l, nh, hd).astype(np.float32)
    if geometry == "random":
        loc = rng.uniform(-0.1, 1.1, (b, l, nh, nl, npts, 2)).astype(np.float32)
    else:
        loc = np.repeat(initial_locations(shapes, nh, npts).numpy(), b, axis=0)
    weights = _softmax(rng.randn(b, l, nh, nl * npts).astype(np.float32)).reshape(b, l, nh, nl, npts)
    return value, loc, weights


def _levels_reference(jx_deformable, value, loc, weights, shapes):
    """Sum over levels of the JAX per-level twin, in the (B, L, nh * hd) output layout."""
    b, l, nh, nl, npts, _ = loc.shape
    hd = value.shape[-1]
    out = np.zeros((b * nh, l, hd), np.float32)
    start = 0
    for lvl, (h, w) in enumerate(shapes):
        v = value[:, start : start + h * w].transpose(0, 2, 1, 3).reshape(b * nh, h * w, hd)
        coords = loc[:, :, :, lvl].transpose(0, 2, 1, 3, 4).reshape(b * nh, l, npts, 2)
        aw = weights[:, :, :, lvl].transpose(0, 2, 1, 3).reshape(b * nh, l, npts)
        gx = coords[..., 0] * np.float32(w) - np.float32(0.5)
        gy = coords[..., 1] * np.float32(h) - np.float32(0.5)
        out += np.asarray(jx_deformable.tent_sample_level_xla(gx, gy, aw, v, h, w))
        start += h * w
    return out.reshape(b, nh, l, hd).transpose(0, 2, 1, 3).reshape(b, l, nh * hd)


_LEVELS_CASES = {
    "2_levels_hd16_random": (((5, 7), (3, 4)), 16, "random"),
    "3_levels_hd32_random": (((9, 11), (5, 6), (3, 3)), 32, "random"),
    "3_levels_hd16_model": (((8, 10), (4, 5), (2, 3)), 16, "model"),
    "3_levels_hd32_model": (((12, 16), (6, 8), (3, 4)), 32, "model"),
}


@pytest.mark.parametrize("case", sorted(_LEVELS_CASES))
def test_deform_levels_plain_matches_jax_twin(jx, case):
    """The multi-level plain K1 against the sum over levels of the JAX per-level
    twin. Tolerance 1e-5: the same f32 bilinear weights summed in another order."""
    _, deformable, _ = jx
    shapes, hd, geometry = _LEVELS_CASES[case]
    value, loc, weights = _levels_inputs(shapes, hd=hd, geometry=geometry)
    ref = _levels_reference(deformable, value, loc, weights, shapes)
    out = deform_sample_levels_plain(torch.from_numpy(value), shapes, torch.from_numpy(loc),
                                     torch.from_numpy(weights))
    assert out.dtype == torch.float32 and out.shape == ref.shape
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5, rtol=1e-5)


def _mca_inputs(b=2, h=4, nq=100, nk=300, hd=32, seed=0):
    """The inputs of `test_pallas_kernels._mca_inputs`, plus one all-unblocked row."""
    rng = np.random.RandomState(seed)
    q = rng.randn(b, h, nq, hd).astype(np.float32)
    k = rng.randn(b, h, nk, hd).astype(np.float32)
    v = rng.randn(b, h, nk, hd).astype(np.float32)
    m = rng.randn(b, nq, nk).astype(np.float32)
    m[:, :3] = -np.abs(m[:, :3]) - 0.1  # all-blocked rows: exempted, attend everything
    m[:, 3] = np.abs(m[:, 3]) + 0.1  # all-unblocked row
    ab = np.all(m < 0.0, axis=-1)
    return q, k, v, m, ab


@pytest.mark.parametrize("nk", [300, 1500])
def test_mca_plain_matches_jax_twin(jx, nk):
    """Tolerance 1e-5: f32 softmax attention, same additive -1e9 mask."""
    _, _, masked_attention = jx
    q, k, v, m, ab = _mca_inputs(nk=nk)
    assert ab[:, :3].all() and not ab[:, 3:].any()
    ref = np.asarray(masked_attention.masked_cross_attention_xla(q, k, v, m, ab))
    out = masked_cross_attention_plain(*(torch.from_numpy(a) for a in (q, k, v, m, ab)))
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5, rtol=1e-5)


LEVELS_480x640 = ((15, 20), (30, 40), (60, 80))


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False


@pytest.mark.cuda
def test_cuda_sampling_locations_equal_cpu():
    """The encoder's reference points and sampling locations have the same bits
    on the card as on the CPU (K1's gradient jumps at exact integer samples)."""
    _need_cuda()
    nh, nl, npts = 8, 3, 4
    ref = reference_points_for_shapes(LEVELS_480x640)
    assert torch.equal(reference_points_for_shapes(LEVELS_480x640, "cuda").cpu(), ref)
    ref = ref[None, :, None, :].expand(1, -1, nl, 2)
    off = torch.from_numpy((np.random.RandomState(0).randn(2, ref.shape[1], nh, nl, npts, 2) * 3).astype(np.float32))
    got = sampling_locations(ref.cuda(), off.cuda(), LEVELS_480x640).cpu()
    assert torch.equal(got, sampling_locations(ref, off, LEVELS_480x640))
    got = initial_locations(LEVELS_480x640, nh, npts, "cuda").cpu()
    assert torch.equal(got, initial_locations(LEVELS_480x640, nh, npts))


@pytest.mark.cuda
def test_cuda_kernels_match_plain():
    """Each CUDA kernel against its plain version on the card, at the 480x640
    main-path shapes and the in-model sampling geometry. Tolerances: 1e-5 in f32
    (same f32 arithmetic, another summation order); 2e-2 for K1 with bf16 values
    and K3 in bf16."""
    _need_cuda()
    dev = "cuda"
    reset_launches()
    value, loc, weights = (torch.from_numpy(a).to(dev) for a in
                           _levels_inputs(LEVELS_480x640, nh=8, b=1, geometry="model"))
    for vt, tol in ((value, 1e-5), (value.bfloat16(), 2e-2)):
        torch.testing.assert_close(
            deform_sample_levels(vt, LEVELS_480x640, loc, weights),
            deform_sample_levels_plain(vt, LEVELS_480x640, loc, weights), atol=tol, rtol=tol,
        )
    start = 0
    for lvl, (h, w) in enumerate(LEVELS_480x640):  # the per-level entry, one level each
        v = value[:, start : start + h * w].permute(0, 2, 1, 3).reshape(8, h * w, 32).contiguous()
        coords = loc[:, :, :, lvl].permute(0, 2, 1, 3, 4).reshape(8, -1, 4, 2)
        gx, gy = (coords[..., 0] * w - 0.5).contiguous(), (coords[..., 1] * h - 0.5).contiguous()
        aw = weights[:, :, :, lvl].permute(0, 2, 1, 3).reshape(8, -1, 4).contiguous()
        torch.testing.assert_close(deform_sample_level(gx, gy, aw, v, h, w),
                                   deform_sample_level_plain(gx, gy, aw, v, h, w), atol=1e-5, rtol=1e-5)
        start += h * w
    for nk in (300, 1200, 4800):
        q, k, v, m, ab = (torch.from_numpy(a).to(dev) for a in _mca_inputs(b=1, h=8, nk=nk))
        q = q * 32**-0.5  # pre-scaled, as the model calls it
        torch.testing.assert_close(
            masked_cross_attention(q, k, v, m, ab), masked_cross_attention_plain(q, k, v, m, ab),
            atol=1e-5, rtol=1e-5,
        )
        qb, kb, vb = q.bfloat16(), k.bfloat16(), v.bfloat16()
        torch.testing.assert_close(
            masked_cross_attention(qb, kb, vb, m, ab).float(),
            masked_cross_attention_plain(qb, kb, vb, m, ab).float(),
            atol=2e-2, rtol=2e-2,
        )
    torch.cuda.synchronize()
    assert LAUNCHES == {"deformable": 5, "masked_attention": 6, "deformable_bwd": 0, "masked_attention_bwd": 0,
                        "point_sample": 0, "point_sample_bwd": 0}


@pytest.mark.cuda
@pytest.mark.parametrize("geometry", ["model", "random", "integer"])
def test_cuda_deform_levels_match_plain(geometry):
    """The one-launch multi-level K1 against its plain version at the 480x640
    levels, B=2 (1e-5 f32, 2e-2 bf16 V); "integer" puts every sample on a pixel
    centre, the borders and one pixel outside them included; the per-level entry
    is checked on exact-integer pixel coordinates too."""
    _need_cuda()
    value, loc, weights = _levels_inputs(LEVELS_480x640, nh=8, geometry="random" if geometry == "random" else "model")
    if geometry == "integer":
        rng = np.random.RandomState(7)
        for lvl, (h, w) in enumerate(LEVELS_480x640):
            ix = rng.randint(-1, w + 1, loc.shape[:3] + (4,))
            iy = rng.randint(-1, h + 1, loc.shape[:3] + (4,))
            loc[:, :, :, lvl, :, 0] = (ix + np.float32(0.5)) / np.float32(w)
            loc[:, :, :, lvl, :, 1] = (iy + np.float32(0.5)) / np.float32(h)
    value, loc, weights = (torch.from_numpy(a).cuda() for a in (value, loc, weights))
    for vt, tol in ((value, 1e-5), (value.bfloat16(), 2e-2)):
        torch.testing.assert_close(
            deform_sample_levels(vt, LEVELS_480x640, loc, weights),
            deform_sample_levels_plain(vt, LEVELS_480x640, loc, weights), atol=tol, rtol=tol,
        )
    gx, gy, aw, v = (torch.from_numpy(a).cuda() for a in _tent_integer_coords())
    torch.testing.assert_close(deform_sample_level(gx, gy, aw, v, 9, 11),
                               deform_sample_level_plain(gx, gy, aw, v, 9, 11), atol=1e-5, rtol=1e-5)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("geometry", ["model", "random", "integer"])
def test_cuda_deform_bf16_equals_f32_of_widened_values(geometry):
    """K1 on bf16 V gives the bits of K1 on V.float(): the kernel widens bf16
    exactly and runs the f32 route's arithmetic in the same order."""
    _need_cuda()
    value, loc, weights = _levels_inputs(LEVELS_480x640, nh=8, geometry="random" if geometry == "random" else "model")
    if geometry == "integer":
        rng = np.random.RandomState(7)
        for lvl, (h, w) in enumerate(LEVELS_480x640):
            loc[:, :, :, lvl, :, 0] = (rng.randint(-1, w + 1, loc.shape[:3] + (4,)) + np.float32(0.5)) / np.float32(w)
            loc[:, :, :, lvl, :, 1] = (rng.randint(-1, h + 1, loc.shape[:3] + (4,)) + np.float32(0.5)) / np.float32(h)
    value, loc, weights = (torch.from_numpy(a).cuda() for a in (value, loc, weights))
    vb = value.bfloat16()
    assert torch.equal(deform_sample_levels(vb, LEVELS_480x640, loc, weights),
                       deform_sample_levels(vb.float(), LEVELS_480x640, loc, weights))
    gx, gy, aw, v = (torch.from_numpy(a).cuda() for a in _tent_integer_coords())
    assert torch.equal(deform_sample_level(gx, gy, aw, v.bfloat16(), 9, 11),
                       deform_sample_level(gx, gy, aw, v.bfloat16().float(), 9, 11))
    torch.cuda.synchronize()


def _mca_edge_inputs(nq, nk, hd, b=2, h=8, seed=0):
    """Random masks plus: row 0 all blocked (exempted), row 1 (row 0 when Q=1)
    unblocked only at the last key, which lies in the last split."""
    rng = np.random.RandomState(seed)
    q = (rng.randn(b, h, nq, hd) * hd**-0.5).astype(np.float32)
    k = rng.randn(b, h, nk, hd).astype(np.float32)
    v = rng.randn(b, h, nk, hd).astype(np.float32)
    m = rng.randn(b, nq, nk).astype(np.float32)
    only_last = 1 if nq > 1 else 0
    m[:, only_last] = -np.abs(m[:, only_last]) - 0.1
    m[:, only_last, -1] = 1.0
    if nq > 1:
        m[:, 0] = -np.abs(m[:, 0]) - 0.1
    ab = np.all(m < 0.0, axis=-1)
    return q, k, v, m, ab


@pytest.mark.cuda
@pytest.mark.parametrize("nk", [1, 63, 64, 65, 300, 1200, 4800, 4801])
def test_cuda_mca_matches_plain(nk):
    """Split-K K3 against its plain version for Q in (1, 100, 129) and hd in
    (16, 32, 64): 1e-5 in f32, 2e-2 in bf16. The row unblocked only at its last
    key must come out as that key's value row exactly (within f32 rounding)."""
    _need_cuda()
    for nq in (1, 100, 129):
        for hd in (16, 32, 64):
            q, k, v, m, ab = (torch.from_numpy(a).cuda() for a in _mca_edge_inputs(nq, nk, hd))
            out = masked_cross_attention(q, k, v, m, ab)
            torch.testing.assert_close(out, masked_cross_attention_plain(q, k, v, m, ab), atol=1e-5, rtol=1e-5)
            only_last = 1 if nq > 1 else 0
            if nk > 1:
                torch.testing.assert_close(out[:, :, only_last], v[:, :, -1], atol=1e-5, rtol=1e-5)
            qb, kb, vb = q.bfloat16(), k.bfloat16(), v.bfloat16()
            torch.testing.assert_close(
                masked_cross_attention(qb, kb, vb, m, ab).float(),
                masked_cross_attention_plain(qb, kb, vb, m, ab).float(), atol=2e-2, rtol=2e-2,
            )
    torch.cuda.synchronize()


def _grads(fn, inputs, grad_out):
    """Gradients of fn(*inputs) for grad_out, through the wrappers' autograd."""
    inputs = [t.detach().requires_grad_() for t in inputs]
    fn(*inputs).backward(grad_out)
    return [t.grad for t in inputs]


def _assert_grad_close(got, ref, rel=1e-5, joint=False):
    """Within rel x the largest |ref| of each gradient, or with `joint` of all of them."""
    scales = [r.float().abs().max().item() for r in ref]
    for g, r, scale in zip(got, ref, scales):
        err = (g.float() - r.float()).abs().max().item()
        assert err <= rel * (max(scales) if joint else scale), (err, scale)


def _k1_bwd_inputs(geometry, b, hd, nh=8, shapes=LEVELS_480x640):
    """K1 inputs at the given levels. "model" and "random" as `_levels_inputs`;
    "integer": every sample on a pixel centre, the borders and one pixel outside
    them included; "spread": the in-model layout (reference points) with offsets
    uniform in +-12 pixels at each level, so neighbouring queries share fewer
    cells; "edge": every offset +5 pixels in x and y, one more than the in-model
    offsets reach, so the samples of the last rows and columns fall off the map."""
    value, loc, weights = _levels_inputs(shapes, nh=nh, hd=hd, b=b,
                                         geometry="random" if geometry == "random" else "model")
    rng = np.random.RandomState(7)
    if geometry == "integer":
        for lvl, (h, w) in enumerate(shapes):
            loc[:, :, :, lvl, :, 0] = (rng.randint(-1, w + 1, loc.shape[:3] + (4,)) + np.float32(0.5)) / np.float32(w)
            loc[:, :, :, lvl, :, 1] = (rng.randint(-1, h + 1, loc.shape[:3] + (4,)) + np.float32(0.5)) / np.float32(h)
    elif geometry in ("spread", "edge"):
        ref = reference_points_for_shapes(shapes)[None, :, None, :].expand(b, -1, len(shapes), 2)
        shape = loc.shape
        off = rng.uniform(-12.0, 12.0, shape) if geometry == "spread" else np.full(shape, 5.0)
        loc = sampling_locations(ref, torch.from_numpy(off.astype(np.float32)), shapes).numpy()
    return value, loc, weights


def _plain_value_cells(gx, gy, h, w):
    """(point, cell) pairs with a non-zero value weight, as the plain backward
    computes them: its 16 candidate cells, cw = ty * tx * valid != 0."""
    from rgbdseg_torch.ops.kernels.deformable import _OFFSETS, _tent_factors

    x0, wx, _ = _tent_factors(gx)
    y0, wy, _ = _tent_factors(gy)
    pairs = set()
    for iy, oy in enumerate(_OFFSETS):
        for ix, ox in enumerate(_OFFSETS):
            yi, xi = y0 + oy, x0 + ox
            valid = ((xi >= 0) & (xi <= w - 1) & (yi >= 0) & (yi <= h - 1)).float()
            on = torch.nonzero(wy[iy] * wx[ix] * valid != 0).squeeze(1)
            pairs.update(zip(on.tolist(), (yi[on] * w + xi[on]).long().tolist()))
    return pairs


@pytest.mark.parametrize("geometry", ["integer", "spread", "edge"])
def test_deform_bwd_tile_lists_hold_plain_value_cells(geometry):
    """The K1 backward's bucketing, in its plain version (`tile_lists_plain`,
    which the card's bitmaps equal: `test_cuda_deform_backward_lists_equal_plain`),
    against the cells the plain backward adds d value to, at the 480x640 levels:
    every query is listed, once, in each tile that one of its points' value
    corners lies in and in no other, the lists ascending, and queries with no
    corner on the map (the "edge" geometry's) in no list."""
    b, nh = 1, 2
    _, loc, _ = _k1_bwd_inputs(geometry, b, 16, nh=nh)
    loc = torch.from_numpy(loc)
    l = loc.shape[1]
    th, tw = _deform.TILE
    off_map = 0
    for h_ in range(nh):
        for lvl, (h, w) in enumerate(LEVELS_480x640):
            xy = loc[0, :, h_, lvl]  # (l, P, 2)
            gx, gy = xy[..., 0] * w - 0.5, xy[..., 1] * h - 0.5
            lists = _deform.tile_lists_plain(gx, gy, h, w)
            assert len(lists) == -(-h // th) * -(-w // tw)
            assert all(bool((t[1:] > t[:-1]).all()) for t in lists)
            got = {(q, tile) for tile, t in enumerate(lists) for q in t.tolist()}
            cells = _plain_value_cells(gx.reshape(-1), gy.reshape(-1), h, w)
            ntx = -(-w // tw)
            assert got == {(p // 4, c // w // th * ntx + c % w // tw) for p, c in cells}
            off_map += l - len({p // 4 for p, _ in cells})
    assert off_map > 0 if geometry == "edge" else True


def test_deform_bwd_tile_plan():
    """The backward's tiles at the 480x640 levels (15x20, 30x40, 60x80): 4x8
    cells everywhere, and 8, 4 and 1 gather warps per tile at the in-model 6300
    queries (a tile lists about 1344, 336 and 84 queries there if they spread
    evenly), so that the warps' parts are of similar length; at most 8 warps,
    at least 1; the bitmaps' scratch at the in-model shapes."""
    assert _deform.tile_plan(LEVELS_480x640, 6300) == [(4, 8, 8), (4, 8, 4), (4, 8, 1)]
    for shapes, nq in ((((9, 11),), 200), (((150, 200),), 1), (((1, 1), (2, 3), (60, 80)), 10**6)):
        for (h, w), (th, tw, wpt) in zip(shapes, _deform.tile_plan(shapes, nq)):
            assert (th, tw) == _deform.TILE and wpt in (1, 2, 4, 8)
    assert [p[2] for p in _deform.tile_plan(((1, 1), (150, 200), (150, 200)), 100)] == [1, 1, 1]
    assert [p[2] for p in _deform.tile_plan(((1, 1), (150, 200)), 10**6)] == [8, 8]
    words, total = _deform.scratch_layout(LEVELS_480x640, 16, 6300)
    assert (words, total) == (197, 16 * (150 + 40 + 12) * 197 + 16 * 3 * 6300 * 12)


def _k1_bwd_twice(fn, inputs, grad_out):
    """Gradients through the wrappers' autograd, twice; asserts one backward
    launch each and the same bits in both."""
    reset_launches()
    got = _grads(fn, inputs, grad_out)
    assert LAUNCHES["deformable_bwd"] == 1
    again = _grads(fn, inputs, grad_out)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [16, 32])
@pytest.mark.parametrize("b", [1, 2])
@pytest.mark.parametrize("geometry", ["model", "random", "integer", "spread", "edge"])
def test_cuda_deform_backward_matches_plain(geometry, b, hd):
    """The K1 backward kernels (through the autograd Function) against the plain
    backward at the 480x640 levels, within 1e-5 x max |ref| for each of d value,
    d locations and d weights: d value is summed in a fixed order (the tiles'
    lists), another than the plain sum's, so it differs from it in the last
    bits only; two launches give the same bits in all three. With bf16 V the
    same, but d value comes back in bf16 from the kernels: 1e-2 x max |ref| (a
    bf16 rounding of each side). The per-level entry is checked on integer
    coordinates, f32 and bf16 v, twice too."""
    _need_cuda()
    value, loc, weights = (torch.from_numpy(a).cuda() for a in _k1_bwd_inputs(geometry, b, hd))
    g = torch.randn(b, value.shape[1], 8 * hd, device="cuda", generator=torch.Generator("cuda").manual_seed(0))
    starts = [0, 300, 1500]
    for vt, dv_rel in ((value, 1e-5), (value.bfloat16(), 1e-2)):
        got = _k1_bwd_twice(lambda a, b_, c: deform_sample_levels(a, LEVELS_480x640, b_, c), (vt, loc, weights), g)
        ref = deform_sample_levels_plain_bwd(vt, LEVELS_480x640, loc, weights, g)
        assert got[0].dtype == vt.dtype
        assert _deform._launch_bwd(vt, loc, weights, LEVELS_480x640, starts, True, g)[0].dtype == vt.dtype
        _assert_grad_close(got[:1], ref[:1], rel=dv_rel)
        _assert_grad_close(got[1:], ref[1:])
    gx, gy, aw, v = (torch.from_numpy(a).cuda() for a in _tent_integer_coords(hd=hd))
    g1 = torch.randn(gx.shape[0], gx.shape[1], v.shape[-1], device="cuda")
    for vt, dv_rel in ((v, 1e-5), (v.bfloat16(), 1e-2)):
        got = _k1_bwd_twice(lambda a, b_, c, d: deform_sample_level(a, b_, c, d, 9, 11), (gx, gy, aw, vt), g1)
        ref = deform_sample_level_plain_bwd(gx, gy, aw, vt, 9, 11, g1)
        assert got[3].dtype == vt.dtype
        _assert_grad_close(got[:3], ref[:3])
        _assert_grad_close(got[3:], ref[3:], rel=dv_rel)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("geometry", ["model", "spread", "edge"])
def test_cuda_deform_backward_4_heads_same_bits(geometry):
    """At 4 heads (one rank's share under model_parallel_size 2), B=2: the K1
    backward against the plain one, and two launches with the same bits, f32
    and bf16 V; the per-level entry on one level of it, both dtypes."""
    _need_cuda()
    value, loc, weights = (torch.from_numpy(a).cuda() for a in _k1_bwd_inputs(geometry, 2, 32, nh=4))
    g = torch.randn(2, value.shape[1], 4 * 32, device="cuda", generator=torch.Generator("cuda").manual_seed(1))
    for vt, dv_rel in ((value, 1e-5), (value.bfloat16(), 1e-2)):
        got = _k1_bwd_twice(lambda a, b_, c: deform_sample_levels(a, LEVELS_480x640, b_, c), (vt, loc, weights), g)
        ref = deform_sample_levels_plain_bwd(vt, LEVELS_480x640, loc, weights, g)
        assert got[0].dtype == vt.dtype
        _assert_grad_close(got[:1], ref[:1], rel=dv_rel)
        _assert_grad_close(got[1:], ref[1:])
    h, w = LEVELS_480x640[1]
    v = value[:, 300:1500].permute(0, 2, 1, 3).reshape(8, h * w, 32).contiguous()
    coords = loc[:, :, :, 1].permute(0, 2, 1, 3, 4).reshape(8, -1, 4, 2)
    gx, gy = (coords[..., 0] * w - 0.5).contiguous(), (coords[..., 1] * h - 0.5).contiguous()
    aw = weights[:, :, :, 1].permute(0, 2, 1, 3).reshape(8, -1, 4).contiguous()
    g1 = torch.randn(8, gx.shape[1], 32, device="cuda", generator=torch.Generator("cuda").manual_seed(2))
    for vt, dv_rel in ((v, 1e-5), (v.bfloat16(), 1e-2)):
        got = _k1_bwd_twice(lambda a, b_, c, d: deform_sample_level(a, b_, c, d, h, w), (gx, gy, aw, vt), g1)
        ref = deform_sample_level_plain_bwd(gx, gy, aw, vt, h, w, g1)
        _assert_grad_close(got[:3], ref[:3])
        _assert_grad_close(got[3:], ref[3:], rel=dv_rel)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("geometry", ["model", "integer", "spread", "edge"])
def test_cuda_deform_backward_lists_equal_plain(geometry):
    """The K1 backward's bucketing on the card: per (b, head, level) and tile,
    the bitmap's set bits are exactly the queries `tile_lists_plain` lists (in
    ascending order, as the gather walks them)."""
    _need_cuda()
    b, nh = 2, 8
    value, loc, weights = (torch.from_numpy(a).cuda() for a in _k1_bwd_inputs(geometry, b, 32))
    l = loc.shape[1]
    g = torch.randn(b, l, nh * 32, device="cuda")
    words, _ = _deform.scratch_layout(LEVELS_480x640, b * nh, l)
    th, tw = _deform.TILE
    ntiles = sum(-(-h // th) * -(-w // tw) for h, w in LEVELS_480x640)
    scratch = _deform._launch_bwd_impl(value, loc, weights, LEVELS_480x640, [0, 300, 1500], True, g)[3]
    bitmaps = scratch[: b * nh * ntiles * words].cpu()
    bits = (bitmaps.reshape(b * nh, ntiles, words, 1) >> torch.arange(32, dtype=torch.int32)) & 1
    loc = loc.cpu()
    for bh in range(b * nh):
        first = 0
        for lvl, (h, w) in enumerate(LEVELS_480x640):
            xy = loc[bh // nh, :, bh % nh, lvl]
            want = _deform.tile_lists_plain(xy[..., 0] * w - 0.5, xy[..., 1] * h - 0.5, h, w)
            for t, ref in enumerate(want):
                got = torch.nonzero(bits[bh, first + t].reshape(-1)).squeeze(1)
                assert torch.equal(got, ref), (bh, lvl, t)
            first += len(want)


@pytest.mark.cuda
@pytest.mark.parametrize("nk", [1, 63, 65, 300, 1200, 4800, 4801])
def test_cuda_mca_backward_matches_plain(nk):
    """The K3 backward kernels against autograd of the plain version, Q in (1,
    100, 129) and hd in (16, 32, 64), all-blocked rows and a row unblocked only
    at its last key included (K=4801: that key alone in the last tile): d q, d k,
    d v within 1e-5 x the largest |ref| of the three (float32-accurate 3xTF32
    products in another order, probabilities from the forward's log-sum-exp;
    with K=1, d q and d k are exactly 0 in the plain version and rounding-sized
    in the kernel). Two launches give the same bits (no atomics). In bf16 the
    kernel runs bf16 products and rounds P and d S to bf16 where the JAX VJP
    does: against the plain backward in bf16 (which rounds there too, and d P),
    2e-2 x the largest |ref|, and against the float32 plain backward of the
    same bf16 values (which rounds nothing), 1e-2 x the largest |ref|; two
    launches give the same bits, and the kernels' own outputs are bf16."""
    _need_cuda()
    for nq in (1, 100, 129):
        for hd in (16, 32, 64):
            q, k, v, m, ab = (torch.from_numpy(a).cuda() for a in _mca_edge_inputs(nq, nk, hd))
            g = torch.randn(q.shape, device="cuda")
            reset_launches()
            got = _grads(lambda a, b, c: masked_cross_attention(a, b, c, m, ab), (q, k, v), g)
            assert LAUNCHES["masked_attention_bwd"] == 1
            _assert_grad_close(got, masked_cross_attention_plain_bwd(q, k, v, m, ab, g), joint=True)
            again = _grads(lambda a, b, c: masked_cross_attention(a, b, c, m, ab), (q, k, v), g)
            assert all(torch.equal(x, y) for x, y in zip(got, again))
            qb, kb, vb, gb = (t.bfloat16() for t in (q, k, v, g))
            got = _grads(lambda a, b, c: masked_cross_attention(a, b, c, m, ab), (qb, kb, vb), gb)
            assert all(x.dtype == torch.bfloat16 for x in got)
            _assert_grad_close(got, masked_cross_attention_plain_bwd(qb, kb, vb, m, ab, gb), rel=2e-2, joint=True)
            _assert_grad_close(got, masked_cross_attention_plain_bwd(*(t.float() for t in (qb, kb, vb)), m, ab,
                                                                     gb.float()), rel=1e-2, joint=True)
            again = _grads(lambda a, b, c: masked_cross_attention(a, b, c, m, ab), (qb, kb, vb), gb)
            assert all(torch.equal(x, y) for x, y in zip(got, again))
            out, lse = _mca._launch(qb, kb, vb, m, ab)
            assert all(x.dtype == torch.bfloat16 for x in _mca._launch_bwd(qb, kb, vb, m, ab, out, lse, gb))
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_cuda_channel_builder_equals_cpu_bitwise():
    """A 720x1280 camera frame to the 480x640 0.4.0 stack on the card and on the
    CPU (`data/device_preprocess.py`, no kernel of the port): the grayscale, the
    resizes and the whole float stack equal bit for bit (the Sobel square root
    is taken in float64 for that, `ops/sobel.py`)."""
    from rgbdseg_torch.config import PreprocessConfig
    from rgbdseg_torch.data.device_preprocess import build_pixels, pil_grayscale_u8
    from rgbdseg_torch.ops.resize_exact import cv2_resize_linear_u8, pil_resize_u8

    _need_cuda()
    rng = np.random.RandomState(0)
    rgb = rng.randint(0, 256, (720, 1280, 3)).astype(np.uint8)
    yy, xx = np.mgrid[0:720, 0:1280]
    depth = np.clip(np.round(150 + 0.1 * yy - 0.05 * xx), 0, 255).astype(np.uint8)
    depth[200:400, 300:700] = 70
    depth[rng.rand(720, 1280) < 0.01] = 0
    cpu = [torch.from_numpy(a)[None] for a in (rgb, np.repeat(depth[..., None], 3, -1))]
    gpu = [a.cuda() for a in cpu]
    pp = PreprocessConfig(height=480, width=640)
    stages = [
        lambda r, d: pil_grayscale_u8(d),
        lambda r, d: pil_resize_u8(r, (480, 640), has_channels=True),
        lambda r, d: pil_resize_u8(d, (480, 640), has_channels=True),
        lambda r, d: cv2_resize_linear_u8(pil_grayscale_u8(d), (480, 640), has_channels=False),
        lambda r, d: build_pixels("map_10channel_case2", r, d, pp),
    ]
    for stage in stages:
        assert torch.equal(stage(*gpu).cpu(), stage(*cpu))


@pytest.mark.cuda
def test_cuda_forward_depends_on_input_values_only():
    """One 480x640 stack forwarded on the card from two layouts, numpy's `a[None]`
    (batch stride 0) and a full batch stride, gives the same logits bit for bit
    (`models/mask2former.py::standard_layout`: cuDNN picks NCHW or NHWC kernels
    from the strides of the first convolution's input)."""
    from rgbdseg_torch.config import ModelConfig
    from rgbdseg_torch.models.mask2former import Mask2FormerRGBD
    from rgbdseg_torch.utils.weights import init_weights

    _need_cuda()
    torch.backends.cudnn.allow_tf32 = False
    model = init_weights(Mask2FormerRGBD(ModelConfig(num_labels=40, version="0.4.0")), 0).cuda().eval()
    rng = np.random.RandomState(0)
    x = rng.randn(480, 640, 10).astype(np.float32)
    x[..., 9] = rng.rand(480, 640) > 0.3
    a = torch.from_numpy(x[None]).cuda()
    b = a.clone(memory_format=torch.contiguous_format)
    assert a.stride()[0] == 0 and b.stride()[0] != 0
    with torch.no_grad():
        oa, ob = model(a), model(b)
    assert torch.equal(oa.class_queries_logits, ob.class_queries_logits)
    assert torch.equal(oa.masks_queries_logits, ob.masks_queries_logits)
