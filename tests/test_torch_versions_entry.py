"""The entry points with the ablation versions, on the CPU at a tiny size (the
port alone; the numerics are held against the JAX package by the other
`tests/test_torch_versions_*.py` files).

- `Predictor.predict_example` from PNG frames at another size than the
  target: the device builder's path (the packed frames the layout reads) and,
  for the two host-only layouts, the host map function give the instances of
  `predict_pixels` on the host map function's stack, for all 13 versions;
- `finetune_torch.main` trains one version of each fusion family on a
  synthetic set with 10 frames per record (0.0.7 and 0.1.1 read 2 frames,
  0.3.0 3, 0.2.0 all 10 through the host builder), writes its checkpoint and
  HF export, and `predict_torch.main` serves the export with the frames the
  layout needs.
"""

import json

import numpy as np
import pytest
import torch

import finetune_torch
import predict_torch
from rgbdseg_torch import versions as TV
from rgbdseg_torch.config import ModelConfig, PreprocessConfig
from rgbdseg_torch.data import device_preprocess as DP
from rgbdseg_torch.data import registry as R
from rgbdseg_torch.data import synthetic
from rgbdseg_torch.inference.predictor import Predictor
from rgbdseg_torch.ops.kernels import LAUNCHES, reset_launches

HW = 64
OTHERS = sorted(set(TV.REGISTRY) - {"0.0.0", "0.4.0"})


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """As `tests/test_torch_cli.py`: the tiny models gain nothing from torch's
    intra-op pool when the suite's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("versions")
    fx = synthetic.generate(str(root / "set"), num_train=4, num_valid=2, size=(80, 96), seed=5, num_modalities=8)
    return root, fx


@pytest.mark.parametrize("version", OTHERS)
def test_predict_example_equals_predict_pixels_of_the_host_stack(dataset, version):
    _, fx = dataset
    records = json.load(open(fx["train"]))
    example = {"image": [f"{fx['root']}/{p}" for p in records[0]["image"]]}
    cfg = ModelConfig.tiny(num_labels=3, version=version)
    pp = PreprocessConfig(height=HW, width=HW)
    pred = Predictor(cfg, device="cpu", seed=1, preprocess=pp)
    reset_launches()
    got = pred.predict_example(example, threshold=0.0)
    map_fn = TV.get(version).map_fn
    frames = DP.packed_width(map_fn) // 3 if DP.supported(map_fn) else len(example["image"])
    assert pred.last_upload_bytes == (80 * 96 * 3 * frames if DP.supported(map_fn)
                                      else HW * HW * TV.get(version).channels.total * 4)
    pix, _, _ = R.MAP_FUNCTIONS[map_fn](example, pp)
    want = pred.predict_pixels(pix[None], threshold=0.0)[0]
    assert set(LAUNCHES.values()) == {0}
    assert got["segments_info"] == want["segments_info"] and len(got["segments_info"]) == cfg.num_queries
    np.testing.assert_array_equal(got["segmentation"], want["segmentation"])


@pytest.mark.parametrize("version", ["0.0.7", "0.1.1", "0.2.0", "0.3.0"])
def test_finetune_and_predict_a_version(dataset, version, tmp_path):
    root, fx = dataset
    (tmp_path / "tiny.json").write_text(ModelConfig.tiny(num_labels=3, version=version).to_json())
    out = tmp_path / "run"
    config = {"root_path": fx["root"], "train_json_path": "train.json", "valid_json_path": "valid.json",
              "label2id_path": "label2id.json", "image_height": HW, "image_width": HW, "version": version,
              "max_instances": 6, "model_config_json": str(tmp_path / "tiny.json"), "output_dir": str(out),
              "num_train_epochs": 1, "per_device_train_batch_size": 2, "per_device_eval_batch_size": 2,
              "learning_rate": 1e-4, "weight_decay": 0.05, "seed": 42, "dataloader_num_workers": 2}
    (tmp_path / "config.json").write_text(json.dumps(config))
    trainer = finetune_torch.main([str(tmp_path / "config.json"), "--device", "cpu"])
    assert trainer.cfg.version == version
    assert trainer.train_dataset.device_channels == DP.supported(TV.get(version).map_fn)
    losses = [e["loss"] for e in trainer.log_history if "loss" in e]
    assert losses and all(np.isfinite(losses))
    state = json.loads((out / "trainer_state.json").read_text())
    assert state["global_step"] == 2
    assert json.loads((out / "config.json").read_text())["rgbdseg_version"] == version

    records = json.load(open(fx["valid"]))
    frames = [f"{fx['root']}/{p}" for p in records[0]["image"]]
    res = predict_torch.main(["--hf_checkpoint", str(out), "--image", frames[0], "--depth", frames[1],
                              *[a for f in frames[2:] for a in ("--extra_frame", f)],
                              "--image_height", str(HW), "--image_width", str(HW), "--threshold", "0.0",
                              "--model_config_json", str(tmp_path / "tiny.json"), "--device", "cpu"])
    want = Predictor(trainer.cfg, state_dict=trainer.model.state_dict(), device="cpu",
                     preprocess=PreprocessConfig(height=HW, width=HW)).predict_example({"image": frames}, 0.0)
    assert res["segments_info"] == want["segments_info"]
    np.testing.assert_array_equal(res["segmentation"], want["segmentation"])
