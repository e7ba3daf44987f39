"""The forward of every dual-backbone version (a second Swin on the depth
channels: 0.1.0, 0.1.1, 0.1.3, 0.2.0, 0.3.0), port against the JAX package,
on the CPU at tiny size; and the logits of one stack in two memory layouts.
Weights and tolerance as `tests/test_torch_versions_forward.py`.
"""

import pytest
import torch

from torch_versions_common import TV, VERSIONS, check_forward, frames, jax_variables, port_model

DUAL = [v for v in VERSIONS if TV.get(v).fusion.dual_backbone]


@pytest.mark.parametrize("version", DUAL)
def test_forward_matches_jax(version):
    check_forward(version)


@pytest.mark.parametrize("version,conv", [("0.1.1", "depth_encoder.patch_embed"),
                                          ("0.0.7", "intrinsics_predictor.conv0")])
def test_stack_convolutions_see_one_layout(version, conv):
    """numpy's `a[None]` has batch stride 0, which made torch run a convolution
    that reads the stack in another memory format than a full copy does (the
    layout fault in ROADMAP §3). The depth encoder's patch convolution
    and the intrinsics predictor's first one see one layout for both, and the
    logits are equal bit for bit."""
    _, v = jax_variables(version)
    model = port_model(version, v).eval()
    x = frames(version, b=1)[0]
    seen, outs = [], []
    hook = model.pixel_level_module.get_submodule(conv).register_forward_pre_hook(
        lambda m, args: seen.append(args[0].stride()))
    try:
        with torch.no_grad():
            for t in (torch.from_numpy(x[None]), torch.from_numpy(x[None]).clone(memory_format=torch.contiguous_format)):
                outs.append(model(t))
    finally:
        hook.remove()
    assert seen[0] == seen[1] and seen[0][0] != 0
    for p, q in zip(outs[0][:2], outs[1][:2]):
        assert torch.equal(p, q)
