"""The forward of every single-backbone version, port against the JAX package,
on the CPU at tiny size (the counterpart of
`tests/test_model.py::test_forward_shapes_all_versions`; the dual-backbone
versions are in `tests/test_torch_versions_dual.py`). Weights: the JAX
variable tree filled from seeded numpy, loaded into the port by `from_flax`
with `strict=True` (`tests/torch_versions_common.py`). Tolerance 1e-4
atol/rtol: f32 reductions over ~30 stacked layers in another order.
"""

import pytest

from torch_versions_common import TV, VERSIONS, check_forward

SINGLE = [v for v in VERSIONS if not TV.get(v).fusion.dual_backbone]


@pytest.mark.parametrize("version", SINGLE)
def test_forward_matches_jax(version):
    check_forward(version)
