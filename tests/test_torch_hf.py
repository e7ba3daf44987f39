"""The port's HF weight bridge, model card and hub upload against the JAX
package, on the CPU (no download, no JAX compile).

- `rgbdseg_torch.utils.safetensors` writes what `safetensors.numpy` reads and
  reads what it writes, byte for byte the same file for the same tensors.
- `to_flax` of the port's seeded tiny 0.4.0, 0.0.0, 0.1.1 and 0.3.0 (dual
  backbone) and 0.0.7 (intrinsics predictor) models -> the JAX
  package's `export_hf_checkpoint` -> the port's `load_hf_checkpoint` gives the
  port's state_dict back bit for bit; the port's `export_hf_checkpoint` -> the
  JAX `load_hf_checkpoint` gives `to_flax` of the port's weights bit for bit.
- `graft` loads what fits and reports a class head of another size.
- The model card is the JAX one with the port's package name and framework.
- `push_to_hub` as `tests/test_hub.py` holds the JAX one, on a filesystem stub
  of `huggingface_hub.HfApi`.
"""

import json
import os
import sys
import types

import jax
import numpy as np
import pytest
import torch
from safetensors.numpy import load_file as lib_load
from safetensors.numpy import save_file as lib_save

from rgbdseg_tpu.config import ModelConfig as JConfig
from rgbdseg_tpu.train import model_card as JMC
from rgbdseg_tpu.train.arguments import TrainingArguments as JTrainingArguments
from rgbdseg_tpu.utils import hf_convert as JH
from rgbdseg_torch.config import ModelConfig
from rgbdseg_torch.models.mask2former import Mask2FormerRGBD
from rgbdseg_torch.train import hub as hub_mod
from rgbdseg_torch.train import model_card as TMC
from rgbdseg_torch.train.arguments import TrainingArguments
from rgbdseg_torch.utils import hf_convert as TH
from rgbdseg_torch.utils import safetensors as TS
from rgbdseg_torch.utils.weights import init_weights, to_flax

ID2LABEL = {0: "background", 1: "box", 2: "ball"}


def _tensors():
    rng = np.random.RandomState(0)
    return {"b.weight": rng.randn(3, 4).astype(np.float32), "a.bias": rng.randn(4).astype(np.float32),
            "n": np.asarray(7, np.int64), "h": rng.randn(2, 2).astype(np.float16), "i": np.arange(5, dtype=np.int32),
            "u": np.arange(3, dtype=np.uint8), "m": np.array([True, False]), "d": rng.randn(3),
            "e": np.zeros((0, 3), np.float32)}


@pytest.mark.parametrize("metadata", [{"format": "pt"}, None])
def test_safetensors_both_ways_byte_for_byte(tmp_path, metadata):
    t = _tensors()
    lib_save(t, str(tmp_path / "lib.safetensors"), metadata=metadata)
    TS.save_file(t, str(tmp_path / "port.safetensors"), metadata=metadata)
    assert (tmp_path / "port.safetensors").read_bytes() == (tmp_path / "lib.safetensors").read_bytes()
    back = TS.load_file(str(tmp_path / "lib.safetensors"))
    for k, v in t.items():
        assert back[k].numpy().dtype == v.dtype and back[k].shape == v.shape
        np.testing.assert_array_equal(back[k].numpy(), v)
    back = lib_load(str(tmp_path / "port.safetensors"))
    for k, v in t.items():
        np.testing.assert_array_equal(back[k], v)


def test_safetensors_writes_torch_tensors_and_rejects_bad_files(tmp_path):
    t = {"x": torch.arange(6, dtype=torch.bfloat16).reshape(2, 3), "y": torch.ones(2)}
    TS.save_file(t, str(tmp_path / "t.safetensors"))
    back = TS.load_file(str(tmp_path / "t.safetensors"))
    assert back["x"].dtype == torch.bfloat16 and torch.equal(back["x"], t["x"]) and torch.equal(back["y"], t["y"])
    (tmp_path / "bad.safetensors").write_bytes((1 << 40).to_bytes(8, "little") + b"{}")
    with pytest.raises(ValueError, match="runs past"):
        TS.load_file(str(tmp_path / "bad.safetensors"))


def _port_model(version, num_labels=3, seed=3):
    cfg = ModelConfig.tiny(num_labels=num_labels, version=version)
    return cfg, init_weights(Mask2FormerRGBD(cfg), seed)


@pytest.mark.parametrize("version", ["0.4.0", "0.0.0", "0.1.1", "0.3.0", "0.0.7"])
def test_jax_export_loads_into_the_port_bitwise(tmp_path, version):
    cfg, model = _port_model(version)
    sd0 = model.state_dict()
    params, stats = to_flax(sd0)
    JH.export_hf_checkpoint(params, stats, JConfig.tiny(num_labels=3, version=version), str(tmp_path), ID2LABEL)
    cfg2, sd = TH.load_hf_checkpoint(str(tmp_path), version=version)
    assert cfg2 == cfg
    assert sd.keys() == sd0.keys()
    for k, v in sd0.items():
        assert sd[k].dtype == v.dtype and torch.equal(sd[k], v), k


@pytest.mark.parametrize("version", ["0.4.0", "0.0.0", "0.1.1", "0.3.0", "0.0.7"])
def test_port_export_loads_into_jax_bitwise(tmp_path, version):
    cfg, model = _port_model(version)
    TH.export_hf_checkpoint(model, cfg, str(tmp_path), ID2LABEL)
    conf = json.loads((tmp_path / "config.json").read_text())
    assert conf["rgbdseg_version"] == version and conf["id2label"] == {str(k): v for k, v in ID2LABEL.items()}
    jcfg, jparams, jstats = JH.load_hf_checkpoint(str(tmp_path), version="0.0.0", with_batch_stats=True)
    assert jcfg == JConfig.tiny(num_labels=3, version=version)
    params, stats = to_flax(model.state_dict())
    for got, want in ((jparams, params), (jstats, stats)):
        g, w = jax.tree_util.tree_flatten_with_path(got)[0], dict(jax.tree_util.tree_flatten_with_path(want)[0])
        assert len(g) == len(w)
        for path, leaf in g:
            assert np.asarray(leaf).dtype == w[path].dtype
            np.testing.assert_array_equal(np.asarray(leaf), w[path], err_msg=str(path))
    # the port reads its own export back too, BatchNorm statistics included
    _, sd = TH.load_hf_checkpoint(str(tmp_path))
    for k, v in model.state_dict().items():
        assert torch.equal(sd[k], v), k


def test_pytorch_model_bin_is_read(tmp_path):
    cfg, model = _port_model("0.4.0")
    TH.export_hf_checkpoint(model, cfg, str(tmp_path), ID2LABEL)
    tensors = TS.load_file(str(tmp_path / "model.safetensors"))
    os.remove(tmp_path / "model.safetensors")
    torch.save(tensors, tmp_path / "pytorch_model.bin")
    _, sd = TH.load_hf_checkpoint(str(tmp_path))
    for k, v in model.state_dict().items():
        assert torch.equal(sd[k], v), k


def test_graft_reports_a_resized_class_head(tmp_path, caplog):
    _, src = _port_model("0.4.0", num_labels=3, seed=1)
    cfg5, dst = _port_model("0.4.0", num_labels=5, seed=2)
    fresh_head = dst.transformer_module.class_predictor.weight.detach().clone()
    sd = dict(src.state_dict())
    dropped = "pixel_level_module.dggm.enhance0.weight"
    del sd[dropped]
    before = dst.state_dict()[dropped].clone()
    with caplog.at_level("INFO"):
        skipped = TH.graft(dst, sd)
    assert sorted(skipped) == ["transformer_module.class_predictor.bias: checkpoint (4,) vs model (6,)",
                               f"transformer_module.class_predictor.weight: checkpoint "
                               f"{tuple(src.transformer_module.class_predictor.weight.shape)} vs model "
                               f"{tuple(fresh_head.shape)}"]
    assert torch.equal(dst.transformer_module.class_predictor.weight, fresh_head)
    assert torch.equal(dst.state_dict()[dropped], before) and dropped in caplog.text
    for k, v in src.state_dict().items():
        if "class_predictor" not in k and k != dropped:
            assert torch.equal(dst.state_dict()[k], v), k
    # the JAX graft skips the same leaves of the flax tree
    jtree, _ = to_flax(dst.state_dict())
    _, jskipped = JH.graft(jtree, to_flax(src.state_dict())[0])
    assert sorted(s.split(":")[0] for s in jskipped) == ["transformer_module/class_predictor/bias",
                                                          "transformer_module/class_predictor/kernel"]


def test_model_card_equals_jax_apart_from_the_package(tmp_path):
    history = [{"loss": 3.25, "grad_norm": 1.0, "learning_rate": 1e-4, "epoch": 1.0, "step": 2},
               {"eval_loss": 2.5, "eval_map": 0.125, "eval_map_50": 0.5, "eval_runtime": 1.0, "epoch": 1.0,
                "step": 2}]
    kw = dict(model_name="run", eval_metrics={"test_loss": 2.5, "test_map": 0.125, "test_runtime": 1.0,
                                             "epoch": 1.0}, log_history=history, base_model="some/base",
              dataset_name="train.json")
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    JMC.create_model_card(str(tmp_path / "jax"), training_args=JTrainingArguments(learning_rate=1e-4), **kw)
    TMC.create_model_card(str(tmp_path / "port"), training_args=TrainingArguments(learning_rate=1e-4), **kw)
    want = (tmp_path / "jax" / "README.md").read_text().split("### Framework versions")[0]
    got = (tmp_path / "port" / "README.md").read_text()
    head, frameworks = got.split("### Framework versions")
    assert "library_name: rgbdseg_torch" in head and "rgbdseg_tpu" not in got
    assert head.replace("rgbdseg_torch", "rgbdseg_tpu") == want
    assert f"- PyTorch {torch.__version__}" in frameworks


# ------------------------------------------------------- hub (tests/test_hub.py)


def _make_run_dir(tmp_path):
    run = tmp_path / "finished_run"
    (run / "checkpoint-6").mkdir(parents=True)
    (run / "checkpoint-6" / "model.pt").write_bytes(b"\x00" * 64)
    (run / "README.md").write_text("# model card")
    (run / "trainer_state.json").write_text("{}")
    (run / "train_results.json").write_text("{}")
    (run / "all_results.json").write_text("{}")
    return run


class _FsRemoteApi:
    """Filesystem-remote HfApi stub: repos are directories under `root`."""

    root = None
    calls = []

    def __init__(self, token=None):
        type(self).calls.append(("init", token))

    def create_repo(self, repo_id, private=True, exist_ok=False):
        path = os.path.join(self.root, repo_id)
        if os.path.exists(path) and not exist_ok:
            raise FileExistsError(repo_id)
        os.makedirs(path, exist_ok=True)
        type(self).calls.append(("create_repo", repo_id, private, exist_ok))

    def upload_folder(self, repo_id, folder_path):
        import shutil

        dst = os.path.join(self.root, repo_id)
        assert os.path.isdir(dst), "upload_folder before create_repo"
        shutil.copytree(folder_path, dst, dirs_exist_ok=True)
        type(self).calls.append(("upload_folder", repo_id, folder_path))


def _install_stub(monkeypatch, tmp_path):
    _FsRemoteApi.root = str(tmp_path / "remote")
    _FsRemoteApi.calls = []
    os.makedirs(_FsRemoteApi.root, exist_ok=True)
    fake = types.ModuleType("huggingface_hub")
    fake.HfApi = _FsRemoteApi
    monkeypatch.setitem(sys.modules, "huggingface_hub", fake)


def _files(root):
    return {os.path.relpath(os.path.join(d, f), root) for d, _, fs in os.walk(root) for f in fs}


def test_push_to_hub_uploads_exact_file_set(tmp_path, monkeypatch):
    run = _make_run_dir(tmp_path)
    _install_stub(monkeypatch, tmp_path)
    assert hub_mod.push_to_hub(str(run), repo_id="user/run-a", token="tok") is True
    assert ("create_repo", "user/run-a", True, True) in _FsRemoteApi.calls
    assert _files(os.path.join(_FsRemoteApi.root, "user/run-a")) == _files(run) == {
        "README.md", "trainer_state.json", "train_results.json", "all_results.json",
        os.path.join("checkpoint-6", "model.pt")}


def test_push_to_hub_default_repo_id_is_run_basename(tmp_path, monkeypatch):
    run = _make_run_dir(tmp_path)
    _install_stub(monkeypatch, tmp_path)
    assert hub_mod.push_to_hub(str(run) + os.sep) is True
    assert os.path.isdir(os.path.join(_FsRemoteApi.root, "finished_run"))


def test_push_to_hub_failure_returns_false_and_keeps_run(tmp_path, monkeypatch):
    run = _make_run_dir(tmp_path)
    _install_stub(monkeypatch, tmp_path)

    def boom(self, repo_id, folder_path):
        raise ConnectionError("remote unreachable")

    monkeypatch.setattr(_FsRemoteApi, "upload_folder", boom)
    assert hub_mod.push_to_hub(str(run), repo_id="user/run-b") is False
    assert (run / "trainer_state.json").exists() and (run / "checkpoint-6" / "model.pt").exists()


def test_push_to_hub_without_client_is_logged_noop(tmp_path, monkeypatch):
    run = _make_run_dir(tmp_path)
    monkeypatch.setitem(sys.modules, "huggingface_hub", None)  # import -> ImportError
    assert hub_mod.push_to_hub(str(run)) is False
    assert (run / "README.md").exists()
