"""The bf16 policy of every version but 0.4.0 (which
`tests/test_torch_train_full.py::test_bf16_module_dtypes_equal_jax` holds):
each module of the port, the ablation fusion modules included, returns the
dtype of the JAX module of the same name under the JAX trainer's `_cast_bf16`
(flax's output dtypes by abstract evaluation), in train and eval mode.
Weights as `tests/test_torch_versions_forward.py`.
"""

import pytest
from flax import linen as fnn

from test_torch_train_full import assert_bf16_module_dtypes_equal_jax
from torch_versions_common import VERSIONS, frames, jax_variables, port_model


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("version", [v for v in VERSIONS if v != "0.4.0"])
def test_bf16_module_dtypes_equal_jax_all_versions(version, train, monkeypatch):
    """`tests/test_torch_train_full.py::test_bf16_module_dtypes_equal_jax` for
    every other version: under the bf16 policy each module of the port,
    the new fusion modules included, returns the dtype of the JAX module of
    the same name (flax's output dtypes by abstract evaluation)."""
    monkeypatch.setattr(fnn.Dropout, "__call__", lambda self, x, *a, **k: x)
    cfg, v = jax_variables(version)
    assert_bf16_module_dtypes_equal_jax(cfg, v, port_model(version, v), frames(version, b=1), train)
