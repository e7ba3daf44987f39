"""`finetune_torch.py` in two processes on the CPU (torchrun's environment
variables, Gloo, `--device cpu`; tiny 0.4.0 at 64x64, 4 train and 2 valid
images) against one process at the same global batch of 2 (the counterpart of
the JAX package's `tests/test_multihost_exec.py`), as data parallelism
(per-device batch 1) and as tensor parallelism (`model_parallel_size` 2):
- every micro-step's loss within rtol 1e-5 (the trainer logs them per epoch);
- the eval and test metrics within 1e-6 (relative above 1: the losses are
  float32 sums over a different split of the work);
- the same files written, by rank 0 alone, the checkpoints of full tensors;
- the eval takes the several-process device-stats path;
- the tensor-parallel run started again resumes from its last checkpoint on
  both ranks (each takes its slices of the full tensors) and evaluates the
  same weights to the same test metrics.
`max_instances` 4 is below the compaction floor of 8, so the one-process
run's compaction (single-process only, as in the JAX package) keeps every
slot and both runs draw the criterion's points over the same shapes."""

import json
import os
import re
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from rgbdseg_torch.config import ModelConfig
from rgbdseg_torch.data import synthetic
from rgbdseg_torch.models.mask2former import Mask2FormerRGBD

REPO = Path(__file__).resolve().parents[1]
HW = 64


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _config(root: Path, out: Path, per_device: int, **extra) -> Path:
    cfg = {"root_path": str(root / "set"), "train_json_path": "train.json", "valid_json_path": "valid.json",
           "label2id_path": "label2id.json", "image_height": HW, "image_width": HW, "version": "0.4.0",
           "max_instances": 4, "model_config_json": str(root / "tiny.json"), "output_dir": str(out),
           "num_train_epochs": 2, "per_device_train_batch_size": per_device,
           "per_device_eval_batch_size": per_device, "learning_rate": 1e-4, "seed": 42,
           "dataloader_num_workers": 0, "prediction_json_path": str(out / "pred.json"), **extra}
    path = root / f"{out.name}.json"
    path.write_text(json.dumps(cfg))
    return path


def _launch(cfg: Path, env_extra: dict) -> subprocess.Popen:
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONUNBUFFERED="1", **env_extra)
    return subprocess.Popen([sys.executable, str(REPO / "finetune_torch.py"), str(cfg), "--device", "cpu"],
                            cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _finish(procs: list) -> list[str]:
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"process {i} failed:\n{out[-4000:]}"
    return outs


def _losses(log: str) -> list[float]:
    return [x for line in re.findall(r"micro-step losses: (\[.*\])", log) for x in json.loads(line)]


def _metrics(out: Path) -> dict:
    results = json.loads((out / "all_results.json").read_text())
    return {k: v for k, v in results.items()
            if k.startswith(("eval_", "test_")) and not k.endswith(("runtime", "_second", "samples"))}


def _files(out: Path) -> set:
    return {str(p.relative_to(out)) for p in out.rglob("*") if p.is_file()}


def _ranks(cfg: Path) -> list[subprocess.Popen]:
    port = _free_port()
    return [_launch(cfg, {"RANK": str(r), "LOCAL_RANK": str(r), "WORLD_SIZE": "2", "MASTER_ADDR": "localhost",
                          "MASTER_PORT": str(port)}) for r in (0, 1)]


def test_two_processes_match_one(tmp_path):
    synthetic.generate(str(tmp_path / "set"), num_train=4, num_valid=2, size=(HW, HW), seed=3)
    (tmp_path / "tiny.json").write_text(ModelConfig.tiny(num_labels=3, version="0.4.0").to_json())
    one, dp, mp = tmp_path / "one", tmp_path / "dp", tmp_path / "mp"
    cfg_mp = _config(tmp_path, mp, 2, model_parallel_size=2)
    log_one, *logs = _finish([_launch(_config(tmp_path, one, 2), {})] + _ranks(_config(tmp_path, dp, 1))
                             + _ranks(cfg_mp))

    ref, want = _losses(log_one), _metrics(one)
    assert len(ref) == 4 and want
    for out, pair in ((dp, logs[:2]), (mp, logs[2:])):
        for log in pair:
            np.testing.assert_allclose(_losses(log), ref, rtol=1e-5)
            assert "device-stats path" in log
        got = _metrics(out)
        assert set(got) == set(want)
        for k, v in got.items():
            assert abs(v - want[k]) <= 1e-6 * max(1.0, abs(want[k])), (out.name, k)
        assert _files(out) == _files(one)
    assert "device-stats path" not in log_one
    full = torch.load(mp / "checkpoint-4" / "model.pt", weights_only=True)
    Mask2FormerRGBD(ModelConfig.tiny(num_labels=3, version="0.4.0")).load_state_dict(full, strict=True)

    before = _metrics(mp)
    logs = _finish(_ranks(cfg_mp))
    assert all("resumed from" in log and "checkpoint-4" in log for log in logs)
    after = json.loads((mp / "test_results.json").read_text())
    assert {k: v for k, v in after.items() if k in before} == {k: v for k, v in before.items() if k.startswith("test_")}
