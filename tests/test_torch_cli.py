"""The port's entry scripts on the CPU at a tiny size: `finetune_torch.main`
writes every artifact of `finetune.py` (checkpoints pruned to the limit,
trainer_state.json, the results JSON files, the HF export, the model card,
the COCO-RLE JSON and comparison PNGs); a second run grafts that HF export as
its pretrained trunk (its version tag overriding the flag) and evaluates the
same weights to the same test metrics; `predict_torch.main` gives the same
segments from the training checkpoint and from the HF export."""

import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch

import finetune_torch
import predict_torch
from rgbdseg_torch.config import ModelConfig
from rgbdseg_torch.data import synthetic
from rgbdseg_torch.inference.predictor import pop_device_flag
from rgbdseg_torch.train.checkpoints import load_checkpoint_partial

HW = 64


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """The tiny models gain nothing from torch's intra-op pool, whose barriers
    cost the most when the suite's workers share the cores (the resume test
    took 103 s beside five busy processes with 8 threads, 31 s with 1)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def finetuned(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    fx = synthetic.generate(str(root / "set"), num_train=4, num_valid=3, size=(HW, HW), seed=3)
    (root / "tiny.json").write_text(ModelConfig.tiny(num_labels=3, version="0.4.0").to_json())
    out = root / "run"
    config = {"root_path": fx["root"], "train_json_path": "train.json", "valid_json_path": "valid.json",
              "label2id_path": "label2id.json", "image_height": HW, "image_width": HW, "version": "0.4.0",
              "max_instances": 6, "model_config_json": str(root / "tiny.json"), "output_dir": str(out),
              "num_train_epochs": 2, "per_device_train_batch_size": 2, "per_device_eval_batch_size": 2,
              "learning_rate": 1e-4, "seed": 42, "save_total_limit": 1, "dataloader_num_workers": 2,
              "prediction_json_path": str(out / "pred.json"), "gt_json_path": str(out / "gt.json"),
              "comparison_output_dir": str(out / "cmp")}
    (root / "config.json").write_text(json.dumps(config))
    trainer = finetune_torch.main([str(root / "config.json"), "--device", "cpu"])
    return root, Path(fx["root"]), out, config, trainer


def test_pop_device_flag():
    assert pop_device_flag(["a.json", "--device", "cpu"]) == (["a.json"], "cpu")
    assert pop_device_flag(["--device=cuda:1", "--x", "1"]) == (["--x", "1"], "cuda:1")
    assert pop_device_flag(["--x", "1"]) == (["--x", "1"], None)
    with pytest.raises(ValueError, match="needs a value"):
        pop_device_flag(["--device"])


def test_finetune_writes_every_artifact(finetuned):
    _, _, out, _, trainer = finetuned
    assert trainer.device == torch.device("cpu")
    names = sorted(os.listdir(out))
    assert [n for n in names if n.startswith("checkpoint-")] == ["checkpoint-4"]
    for n in ("README.md", "all_results.json", "config.json", "gt.json", "model.safetensors", "pred.json",
              "test_results.json", "train_results.json", "trainer_state.json"):
        assert n in names, n
    state = json.loads((out / "trainer_state.json").read_text())
    assert state["global_step"] == 4 and state["total_flos"] > 0
    assert [e["step"] for e in state["log_history"] if "loss" in e] == [2, 4]
    assert sum("eval_map" in e for e in state["log_history"]) == 2
    results = json.loads((out / "all_results.json").read_text())
    assert results["train_samples"] == 4 and results["test_samples"] == 3 and "test_map" in results
    assert sorted(os.listdir(out / "cmp")) == [f"comparison_{i}.png" for i in range(3)]
    assert all("counts" in r["segmentation"] for r in json.loads((out / "gt.json").read_text()))
    conf = json.loads((out / "config.json").read_text())
    assert conf["rgbdseg_version"] == "0.4.0" and len(conf["id2label"]) == 3
    assert "library_name: rgbdseg_torch" in (out / "README.md").read_text()


def test_finetune_from_the_hf_export_evaluates_the_same_weights(finetuned, tmp_path):
    root, _, out, config, _ = finetuned
    cfg = dict(config, output_dir=str(tmp_path / "again"), model_name_or_path=str(out), version="0.0.0",
               do_train=False, prediction_json_path=None, gt_json_path=None, comparison_output_dir=None)
    (tmp_path / "c.json").write_text(json.dumps(cfg))
    trainer = finetune_torch.main([str(tmp_path / "c.json")], device="cpu")
    assert trainer.cfg.version == "0.4.0"  # from the export's tag
    trained = load_checkpoint_partial(str(out / "checkpoint-4"))
    for k, v in trainer.model.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(v, trained[k]), k
    want = json.loads((out / "test_results.json").read_text())
    got = json.loads((tmp_path / "again" / "test_results.json").read_text())
    timing = ("test_runtime", "test_samples_per_second")
    assert {k: v for k, v in got.items() if k not in timing} == {k: v for k, v in want.items() if k not in timing}


def test_predict_from_checkpoint_and_hf_export_agree(finetuned, tmp_path):
    root, set_root, out, _, _ = finetuned
    common = ["--version", "0.4.0", "--num_labels", "3", "--model_config_json", str(root / "tiny.json"),
              "--image", str(set_root / "images" / "4.png"), "--depth", str(set_root / "depth" / "4.png"),
              "--image_height", str(HW), "--image_width", str(HW), "--threshold", "0.0"]
    a = predict_torch.main(["--checkpoint", str(out / "checkpoint-4"), "--save", str(tmp_path / "a.png")] + common,
                           device="cpu")
    b = predict_torch.main(["--hf_checkpoint", str(out), "--save", str(tmp_path / "b.png"), "--device", "cpu"]
                           + common)
    assert a["segments_info"] == b["segments_info"] and len(a["segments_info"]) > 0
    np.testing.assert_array_equal(a["segmentation"], b["segmentation"])
    assert (tmp_path / "a.png").read_bytes() == (tmp_path / "b.png").read_bytes()


def test_entry_scripts_default_to_cuda_and_raise_without_it(finetuned, monkeypatch):
    root, set_root, out, _, _ = finetuned
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        finetune_torch.main([str(root / "config.json")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        predict_torch.main(["--hf_checkpoint", str(out), "--image", str(set_root / "images" / "4.png"),
                            "--depth", str(set_root / "depth" / "4.png")])
