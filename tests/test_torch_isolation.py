"""The port stands alone: it imports nothing of JAX or of the JAX package (nor
cv2, PIL, safetensors or transformers, which the card's machine lacks, and
matplotlib only inside the one function that draws with it),
its native code is loaded through ctypes only, its entry points run on the
card unless asked otherwise, the kernel wrappers take the plain versions only
for CPU tensors without counting a launch, and the JAX package's variables
load into the port's modules with `strict=True`."""

import ast
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rgbdseg_tpu.config import ModelConfig as JConfig
from rgbdseg_tpu.models.mask2former import Mask2FormerRGBD as JModel
from rgbdseg_torch import versions as TV
from rgbdseg_torch.config import ModelConfig
from rgbdseg_torch.data.pipeline import Batch
from rgbdseg_torch.inference import predictor as tpredictor
from rgbdseg_torch.models.mask2former import Mask2FormerRGBD
from rgbdseg_torch.ops.kernels import LAUNCHES, reset_launches
from rgbdseg_torch.ops.kernels.deformable import (
    deform_sample_level,
    deform_sample_level_plain,
    deform_sample_levels,
    deform_sample_levels_plain,
)
from rgbdseg_torch.ops.kernels.masked_attention import masked_cross_attention, masked_cross_attention_plain
from rgbdseg_torch.train.arguments import TrainingArguments
from rgbdseg_torch.train.trainer import build_training, put_batch
from rgbdseg_torch.utils.weights import from_flax

REPO = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "rgbdseg_tpu", "cv2", "PIL", "safetensors", "transformers"}
PORT_FILES = sorted((REPO / "rgbdseg_torch").rglob("*.py")) + [
    REPO / name for name in ("chip_smoke.py", "kernel_ab.py", "finetune_torch.py", "predict_torch.py")]


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(node.func, "id", "")) in (
            "import_module", "__import__", "importorskip",
        ):
            roots.update(a.value.split(".")[0] for a in node.args[:1] if isinstance(a, ast.Constant))
    return roots


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_port_imports_nothing_forbidden(path):
    assert not _imported_roots(path) & FORBIDDEN


def test_predictor_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpredictor.Predictor(ModelConfig.tiny(version="0.4.0"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpredictor.Predictor(ModelConfig.tiny(version="0.4.0"), device="cuda")
    assert tpredictor.resolve_device("cpu") == torch.device("cpu")


def test_train_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_training(ModelConfig.tiny(version="0.4.0"), TrainingArguments(), 2)
    batch = Batch(np.zeros((1, 4, 4, 6), np.uint8), np.zeros((1, 2, 4, 4), np.float32), np.zeros((1, 2), np.int64),
                  np.ones((1, 2), bool))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        put_batch(batch, TrainingArguments())
    assert put_batch(batch, TrainingArguments(), "cpu").pixel_values.dtype == torch.uint8


def test_native_code_is_loaded_through_ctypes_only():
    native = REPO / "rgbdseg_torch" / "native"
    assert sorted(p.name for p in native.iterdir() if p.name != "__pycache__") == ["__init__.py", "rle.c"]
    roots = _imported_roots(native / "__init__.py")
    assert "ctypes" in roots and roots <= {"__future__", "ctypes", "hashlib", "os", "shutil", "subprocess",
                                           "pathlib", "typing", "numpy"}
    assert not any("native" in str(p) for p in (REPO / "rgbdseg_torch").rglob("*.so"))  # built under build/


def test_visualize_imports_matplotlib_only_when_called():
    tree = ast.parse((REPO / "rgbdseg_torch" / "inference" / "visualize.py").read_text())
    top = {a.name for node in tree.body if isinstance(node, ast.Import) for a in node.names}
    top |= {node.module for node in tree.body if isinstance(node, ast.ImportFrom) and node.module}
    assert not any(m.startswith("matplotlib") for m in top)
    assert "matplotlib" in _imported_roots(REPO / "rgbdseg_torch" / "inference" / "visualize.py")


def test_qa_viewers_draw_without_matplotlib():
    """The QA viewers run on the card's machine, which has no matplotlib: they
    compose their panels as uint8 images and write them with `image_io`."""
    roots = _imported_roots(REPO / "rgbdseg_torch" / "tools" / "qa_viewers.py")
    assert "matplotlib" not in roots and not roots & FORBIDDEN


def test_chip_smoke_fails_without_card_or_checkout(tmp_path):
    """No result line and a non-zero exit: alone in a directory, and (here,
    without CUDA) in the checkout."""
    (tmp_path / "chip_smoke.py").write_bytes((REPO / "chip_smoke.py").read_bytes())
    runs = [subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path, capture_output=True, text=True)]
    if not torch.cuda.is_available():
        runs.append(subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, capture_output=True, text=True))
    for r in runs:
        assert r.returncode != 0
        assert '"ok"' not in r.stdout


def test_cpu_wrappers_take_plain_version_without_launching():
    rng = np.random.RandomState(0)
    gx, gy = (torch.from_numpy(rng.uniform(-2, 25, (2, 50, 4)).astype(np.float32)) for _ in range(2))
    aw = torch.softmax(torch.from_numpy(rng.randn(2, 50, 4).astype(np.float32)), -1)
    v = torch.from_numpy(rng.randn(2, 17 * 23, 32).astype(np.float32))
    q, k, vv = (torch.from_numpy(rng.randn(2, 4, n, 32).astype(np.float32)) for n in (20, 64, 64))
    m = torch.from_numpy(rng.randn(2, 20, 64).astype(np.float32))
    m[:, 0] = -1.0
    ab = (m < 0).all(-1)
    shapes = ((5, 6), (3, 3))
    value = torch.from_numpy(rng.randn(2, 39, 2, 16).astype(np.float32))
    loc = torch.from_numpy(rng.uniform(0, 1, (2, 39, 2, 2, 4, 2)).astype(np.float32))
    wts = torch.softmax(torch.from_numpy(rng.randn(2, 39, 2, 2, 4).astype(np.float32)), -1)
    reset_launches()
    torch.testing.assert_close(
        deform_sample_level(gx, gy, aw, v, 17, 23), deform_sample_level_plain(gx, gy, aw, v, 17, 23)
    )
    torch.testing.assert_close(
        deform_sample_levels(value, shapes, loc, wts), deform_sample_levels_plain(value, shapes, loc, wts)
    )
    torch.testing.assert_close(
        masked_cross_attention(q, k, vv, m, ab), masked_cross_attention_plain(q, k, vv, m, ab)
    )
    assert set(LAUNCHES.values()) == {0}


@pytest.mark.parametrize("version", sorted(TV.REGISTRY))
def test_from_flax_loads_strict(version):
    """Every JAX variable maps onto a port parameter or buffer of the same
    shape, and none is missing (shapes from tracing the JAX init, no compile)."""
    ch = TV.get(version).channels.total
    shapes = jax.eval_shape(
        JModel(JConfig.tiny(num_labels=3, version=version)).init,
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 64, 64, ch), jnp.float32),
    )
    v = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    model = Mask2FormerRGBD(ModelConfig.tiny(num_labels=3, version=version))
    model.load_state_dict(from_flax(v["params"], v.get("batch_stats")), strict=True)


@pytest.mark.parametrize("version", sorted(set(TV.REGISTRY) - {"0.0.0", "0.4.0"}))
def test_unported_versions_raise(version):
    """The 13 versions the port once refused now build; like the JAX model,
    each raises on a stack of another channel count than its layout's."""
    model = Mask2FormerRGBD(ModelConfig.tiny(version=version))
    total = TV.get(version).channels.total
    with pytest.raises(ValueError, match=f"expects {total} channels"):
        model(torch.zeros(1, 64, 64, total + 1))
