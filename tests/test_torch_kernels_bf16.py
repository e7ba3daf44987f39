"""The kernels' plain PyTorch versions on bfloat16 operands against the JAX twins.

The bf16 train step hands K3 bf16 q, k, v and d out, and K1 a bf16 value
tensor. The CUDA kernels are held against these plain versions on the card
(`tests/test_torch_kernels.py`, `cuda`-marked); here the plain versions are
held against the JAX package's twins on the same bf16 values, so both sides
of that chain round where the JAX package rounds:

- K3 forward: the logits of bf16 q k^T come out in bf16, P is rounded to bf16
  before P v, and the output is bf16 (`masked_cross_attention_xla`).
- K3 backward: torch's autograd of the plain version and `jax.vjp` of the twin
  both round d P (d out v^T), d S before d q and d k, and P before d v.
- K1: the JAX twin rounds its tent matrix and its output to bf16
  (`tent_sample_level_xla`); the plain version samples the bf16 values in
  float32, as the kernel does.

Tolerances were measured first (seeds 0-2, the cases below): K3 forward within
1.5e-3 x max |ref|, K3 backward within 1.3e-3 x the largest |ref| of d q, d k
and d v; both sides round at the same points, so the differences are single
bf16 roundings (one bf16 ulp of the largest value is 3.9e-3 of it) of sums
taken in another order: 1e-2 x max |ref|. K1 within 1.2e-2 absolute at
max |ref| 2.7: 2e-2, as `tests/test_pallas_kernels.py` holds the Pallas kernel
on bf16 values.
"""

import numpy as np
import pytest
import torch

from rgbdseg_torch.ops.kernels.deformable import deform_sample_level_plain, deform_sample_levels_plain
from rgbdseg_torch.ops.kernels.masked_attention import masked_cross_attention_plain, masked_cross_attention_plain_bwd
from test_torch_kernels import (
    _LEVELS_CASES,
    _levels_inputs,
    _levels_reference,
    _mca_inputs,
    _tent_inputs,
    _tent_model_shape,
)

K3_RTOL = 1e-2
K1_TOL = 2e-2


@pytest.fixture
def jx():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from rgbdseg_tpu.ops.kernels import deformable, masked_attention

    return jax, jnp, deformable, masked_attention


def _mca_bf16(nk, seed=0):
    """`_mca_inputs` with q pre-scaled as the model calls K3, and a d out; float32 arrays."""
    q, k, v, m, ab = _mca_inputs(nk=nk, seed=seed)
    g = np.random.RandomState(seed + 10).randn(*q.shape).astype(np.float32)
    return q * np.float32(32**-0.5), k, v, m, ab, g


def _rel_err(got, ref):
    """The largest |got - ref| over the arrays, over the largest |ref|."""
    return max(np.abs(a - b).max() for a, b in zip(got, ref)) / max(np.abs(b).max() for b in ref)


@pytest.mark.parametrize("nk", [300, 1500])
def test_mca_plain_bf16_matches_jax_twin(jx, nk):
    _, jnp, _, masked_attention = jx
    q, k, v, m, ab, _ = _mca_bf16(nk)
    ref = masked_attention.masked_cross_attention_xla(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)), m, ab)
    assert ref.dtype == jnp.bfloat16
    out = masked_cross_attention_plain(*(torch.from_numpy(a).bfloat16() for a in (q, k, v)),
                                       torch.from_numpy(m), torch.from_numpy(ab))
    assert out.dtype == torch.bfloat16
    assert _rel_err([out.float().numpy()], [np.asarray(ref.astype(jnp.float32))]) <= K3_RTOL


@pytest.mark.parametrize("nk", [300, 1500])
def test_mca_plain_bf16_backward_matches_jax_vjp(jx, nk):
    jax, jnp, _, masked_attention = jx
    q, k, v, m, ab, g = _mca_bf16(nk)
    _, vjp = jax.vjp(lambda a, b, c: masked_attention.masked_cross_attention_xla(a, b, c, m, ab),
                     *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)))
    ref = vjp(jnp.asarray(g, jnp.bfloat16))
    assert all(r.dtype == jnp.bfloat16 for r in ref)
    got = masked_cross_attention_plain_bwd(*(torch.from_numpy(a).bfloat16() for a in (q, k, v)),
                                           torch.from_numpy(m), torch.from_numpy(ab), torch.from_numpy(g).bfloat16())
    assert all(t.dtype == torch.bfloat16 for t in got)
    err = _rel_err([t.float().numpy() for t in got], [np.asarray(r.astype(jnp.float32)) for r in ref])
    assert err <= K3_RTOL, err


_TENT_CASES = {
    "out_of_bounds_17x23": (lambda: _tent_inputs(), 17, 23),
    "model_shape_60x80": (lambda: _tent_model_shape(), 60, 80),
}


@pytest.mark.parametrize("case", sorted(_TENT_CASES))
def test_deform_plain_bf16_values_match_jax_twin(jx, case):
    _, jnp, deformable, _ = jx
    make, h, w = _TENT_CASES[case]
    gx, gy, aw, v = make()
    ref = np.asarray(deformable.tent_sample_level_xla(gx, gy, aw, jnp.asarray(v, jnp.bfloat16), h, w))
    out = deform_sample_level_plain(*(torch.from_numpy(a) for a in (gx, gy, aw)), torch.from_numpy(v).bfloat16(), h, w)
    assert out.dtype == torch.float32 and out.shape == ref.shape
    np.testing.assert_allclose(out.numpy(), ref, atol=K1_TOL, rtol=K1_TOL)


@pytest.mark.parametrize("case", ["3_levels_hd32_model", "3_levels_hd32_random"])
def test_deform_levels_plain_bf16_values_match_jax_twin(jx, case):
    """The multi-level plain K1 on bf16 V against the sum over levels of the JAX
    per-level twin on the same bf16 values."""
    _, jnp, deformable, _ = jx
    shapes, hd, geometry = _LEVELS_CASES[case]
    value, loc, weights = _levels_inputs(shapes, hd=hd, geometry=geometry)
    vb = torch.from_numpy(value).bfloat16()

    class Bf16Twin:  # the JAX twin on bf16 values, as `_levels_reference` calls it
        @staticmethod
        def tent_sample_level_xla(gx, gy, aw, v, h, w):
            return deformable.tent_sample_level_xla(gx, gy, aw, jnp.asarray(v, jnp.bfloat16), h, w)

    ref = _levels_reference(Bf16Twin, vb.float().numpy(), loc, weights, shapes)
    out = deform_sample_levels_plain(vb, shapes, torch.from_numpy(loc), torch.from_numpy(weights))
    assert out.dtype == torch.float32 and out.shape == ref.shape
    np.testing.assert_allclose(out.numpy(), ref, atol=K1_TOL, rtol=K1_TOL)
