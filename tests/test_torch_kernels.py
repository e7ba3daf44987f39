"""The port's kernel modules against the JAX package's golden twins.

The plain PyTorch versions of K1 (`deform_sample_level`) and K3
(`masked_cross_attention`) are held against `tent_sample_level_xla` and
`masked_cross_attention_xla`, which `tests/test_pallas_kernels.py` pins to the
Pallas kernels. The CUDA kernels themselves are held against the plain versions
by `test_cuda_kernels_match_plain`, which needs a card and skips without one.
JAX is imported inside the `jx` fixture only, so that the CUDA test also runs on
a machine without JAX (`python -m pytest --noconftest tests/test_torch_kernels.py -m cuda`).
"""

import numpy as np
import pytest
import torch

from rgbdseg_torch.ops.kernels import LAUNCHES, reset_launches
from rgbdseg_torch.ops.kernels.deformable import deform_sample_level, deform_sample_level_plain
from rgbdseg_torch.ops.kernels.masked_attention import (
    masked_cross_attention,
    masked_cross_attention_plain,
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


@pytest.mark.cuda
def test_cuda_kernels_match_plain():
    """Each CUDA kernel against its plain version on the card, at the 480x640
    main-path shapes. Tolerances: 1e-5 in f32 (same f32 arithmetic, another
    summation order); 2e-2 for K1 with bf16 values and K3 in bf16."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = "cuda"
    reset_launches()
    for h, w in ((15, 20), (30, 40), (60, 80)):
        gx, gy, aw, v = (torch.from_numpy(a).to(dev) for a in _tent_inputs(bh=8, l=6300, h=h, w=w))
        for vt, tol in ((v, 1e-5), (v.bfloat16(), 2e-2)):
            out = deform_sample_level(gx, gy, aw, vt, h, w)
            ref = deform_sample_level_plain(gx, gy, aw, vt, h, w)
            torch.testing.assert_close(out, ref, atol=tol, rtol=tol)
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
    assert LAUNCHES == {"deformable": 6, "masked_attention": 6}
