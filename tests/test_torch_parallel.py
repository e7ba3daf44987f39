"""The port's parallelism (`rgbdseg_torch/parallel/`) against the JAX package's
(`rgbdseg_tpu/parallel/`), and a parallel step against one process's step.

- The row arithmetic, the mesh's rank grid, the Megatron rules (through
  `utils/weights.py::from_flax`'s names) and `batches(local_rows=...)` equal
  the JAX functions'.
- One train step of the tiny model in 2 or 4 Gloo processes on the CPU
  (`tests/torch_parallel_worker.py`: dp=2, mp=2, dp=2 x mp=2, for 0.4.0 and
  0.0.0) equals one process's step at the global batch: loss within 1e-5
  relative, gradient norm 1e-5 relative, every gradient within 1e-5 of its
  leaf's largest magnitude (the attention key biases, whose exact gradient is
  0 and which hold rounding noise only, within 1e-6 of the largest leaf's, as
  in `tests/test_torch_train.py`), BatchNorm running statistics 1e-6, the
  generator's state equal, the updated parameters within 0.2 x the learning
  rate (one Adam step moves an element by up to the learning rate, and at
  step 1 it maps a clipped gradient element near Adam's eps, 1e-8, to any
  value in between, so a 1e-7 difference there moves the update), and every
  rank's full parameters equal bit for bit. The one-process step is held
  against the JAX step by `tests/test_torch_train.py`, which closes the chain
  to the JAX package's 4-device parity (`tests/test_trainer.py`).
- A world-size-1 DistributedDataParallel step equals the plain step bit for bit.
- `initialize` does nothing in one process, takes Gloo for the CPU, and raises
  for NCCL without CUDA; `num_devices` other than the world size raises.
"""

import functools
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from rgbdseg_tpu.config import ModelConfig as JConfig
from rgbdseg_tpu.data.pipeline import SegmentationDataset as JDataset, load_meta as jload_meta
from rgbdseg_tpu.data.preprocess import PreprocessConfig as JPreprocess
from rgbdseg_tpu.models.mask2former import Mask2FormerRGBD as JModel
from rgbdseg_tpu.parallel.mesh import make_mesh as jmake_mesh
from rgbdseg_tpu.parallel.multihost import _rows_for_process as jrows
from rgbdseg_tpu.parallel.sharding import megatron_param_specs as jspecs
from rgbdseg_torch import versions as TV
from rgbdseg_torch.config import ModelConfig, PreprocessConfig
from rgbdseg_torch.data import synthetic
from rgbdseg_torch.data.pipeline import SegmentationDataset, load_meta
from rgbdseg_torch.models.mask2former import Mask2FormerRGBD
from rgbdseg_torch.parallel.mesh import make_mesh, rank_grid
from rgbdseg_torch.parallel.multihost import _rows_for_process, initialize
from rgbdseg_torch.parallel.sharding import megatron_param_specs
from rgbdseg_torch.train.arguments import TrainingArguments
from rgbdseg_torch.data.pipeline import Batch
from rgbdseg_torch.train.trainer import _pad_rows, build_training, distribute, unwrap
from rgbdseg_torch.utils.weights import from_flax

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_parallel_worker as W  # noqa: E402

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_parallel_worker.py")
LR = 1e-3  # the worker's learning rate


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("procs,pid,batch", [
    ([0, 1], 0, 4), ([0, 1], 1, 4), ([0, 0, 1, 1], 1, 8), ([0, 1, 2, 3], 2, 8), ([0, 0], 0, 2),
    ([0, 1], 2, 4), ([0, 1], 0, 3), ([0, 1, 0], 0, 6),
])
def test_rows_for_process_matches_jax(procs, pid, batch):
    """The same rows, or the same error (a batch that does not divide, indices not contiguous)."""
    try:
        want = jrows(procs, pid, batch)
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e).split(" ")[0]):
            _rows_for_process(procs, pid, batch)
        return
    assert _rows_for_process(procs, pid, batch) == want


@pytest.mark.parametrize("n,model_axis", [(4, 1), (4, 2), (8, 4), (4, 3)])
def test_rank_grid_matches_jax_mesh(n, model_axis):
    """Rank d * model + m is the JAX mesh's device order (the conftest gives JAX 8 CPU devices)."""
    try:
        jgrid = np.vectorize(lambda d: d.id)(jmake_mesh(n, model_axis=model_axis).devices)
    except ValueError:
        with pytest.raises(ValueError, match="not divisible"):
            rank_grid(n, model_axis)
        return
    np.testing.assert_array_equal(rank_grid(n, model_axis), jgrid - min(d.id for d in jax.devices("cpu")))


@pytest.mark.parametrize("version", ["0.0.0", "0.4.0"])
def test_megatron_specs_match_jax(version):
    """Every parameter's rule (column, row, replicated) is the JAX spec of its flax leaf."""
    ch = TV.get(version).channels.total
    shapes = jax.eval_shape(JModel(JConfig.tiny(num_labels=3, version=version)).init,
                            {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 64, 64, ch), jnp.float32))["params"]
    code = {(): 0, (None, "model"): 1, ("model",): 1, ("model", None): 2}
    coded = jax.tree.map(lambda s, spec: np.full(s.shape, code[tuple(spec)], np.float32),
                         shapes, jspecs(shapes), is_leaf=lambda x: isinstance(x, jax.ShapeDtypeStruct))
    want = {k: v.flatten()[0].item() if v.numel() else 0 for k, v in from_flax(coded).items()}
    got = megatron_param_specs(Mask2FormerRGBD(ModelConfig.tiny(num_labels=3, version=version)))
    assert set(got) == set(want)
    assert {k: {None: 0, "col": 1, "row": 2}[v] for k, v in got.items()} == want
    assert sum(v == "col" for v in got.values()) > 0 and sum(v == "row" for v in got.values()) > 0


def test_batches_local_rows_match_jax(tmp_path):
    """Each rank's rows of every shuffled global batch, padding included, as the JAX pipeline assembles them."""
    synthetic.generate(str(tmp_path), num_train=5, num_valid=1, size=(32, 48), seed=1)
    meta = str(tmp_path / "train.json")
    ours = SegmentationDataset(load_meta(meta, str(tmp_path)), "0.4.0", PreprocessConfig(height=32, width=48),
                               max_instances=4)
    theirs = JDataset(jload_meta(meta, str(tmp_path)), "0.4.0", JPreprocess(height=32, width=48), max_instances=4)
    for rows in ((0, 2), (2, 4)):
        got = list(ours.batches(4, shuffle=True, seed=3, epoch=1, num_workers=1, local_rows=rows))
        want = list(theirs.batches(4, shuffle=True, seed=3, epoch=1, num_workers=1, local_rows=rows))
        assert len(got) == len(want) == 2
        for g, w in zip(got, want):
            for field in ("pixel_values", "mask_labels", "class_labels", "valid", "orig_sizes"):
                np.testing.assert_array_equal(getattr(g, field), getattr(w, field))


def test_uneven_batch_is_padded_by_its_first_row():
    """The JAX `_put`'s padding: the first row repeated up to a multiple of the data width, its targets invalid."""
    rng = np.random.RandomState(0)
    b = Batch(rng.rand(3, 4, 4, 2), rng.rand(3, 2, 4, 4), rng.randint(0, 3, (3, 2)), np.ones((3, 2), bool),
              orig_sizes=np.full((3, 2), 4))
    padded = _pad_rows(b, 2)
    assert padded.pixel_values.shape[0] == 4 and padded.mask_labels_packed is None
    for field in ("pixel_values", "mask_labels", "class_labels", "orig_sizes"):
        np.testing.assert_array_equal(getattr(padded, field)[:3], getattr(b, field))
        np.testing.assert_array_equal(getattr(padded, field)[3], getattr(b, field)[0])
    assert padded.valid[:3].all() and not padded.valid[3].any()
    assert _pad_rows(b, 3) is b


@functools.lru_cache(maxsize=None)
def _reference(version: str) -> dict:
    return W.run_step(version)


def _run_workers(tmp_path, version: str, world: int, mp: int) -> list[dict]:
    port = _free_port()
    procs = []
    for rank in range(world):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                   MASTER_ADDR="localhost", MASTER_PORT=str(port), OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen([sys.executable, WORKER, version, str(mp), str(tmp_path)], env=env,
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{out[-3000:]}"
    return [torch.load(tmp_path / f"rank{r}.pt", weights_only=True) for r in range(world)]


def _is_key_bias(name: str) -> bool:
    return name.endswith(("k_proj.bias", "key.bias"))


@pytest.mark.parametrize("version", ["0.4.0", "0.0.0"])
@pytest.mark.parametrize("world,mp", [(2, 1), (2, 2), (4, 2)], ids=["dp2", "mp2", "dp2xmp2"])
def test_parallel_step_matches_one_process(tmp_path, version, world, mp):
    ref = _reference(version)
    recs = _run_workers(tmp_path, version, world, mp)
    if mp > 1:
        assert recs[0]["sharded"], "no parameter was sharded"
    top = max(float(g.abs().max()) for g in ref["grads"].values())
    for rank, rec in enumerate(recs):
        np.testing.assert_allclose(float(rec["loss"]), float(ref["loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(rec["norm"]), float(ref["norm"]), rtol=1e-5)
        assert torch.equal(rec["rng"], ref["rng"]), "the generators went out of step"
        assert set(rec["grads"]) == set(ref["grads"])
        for name, g in ref["grads"].items():
            scale = 1e-6 * top if _is_key_bias(name) else 1e-5 * float(g.abs().max())
            assert float((rec["grads"][name] - g).abs().max()) <= scale, name
        assert set(rec["state"]) == set(ref["state"])
        for name, t in ref["state"].items():
            got = rec["state"][name]
            if name.endswith("num_batches_tracked"):
                assert torch.equal(got, t), name
            elif "running_" in name:
                assert float((got - t).abs().max()) <= 1e-6, name
            else:
                assert float((got - t).abs().max()) <= 0.2 * LR, name
        for name, t in recs[0]["state"].items():
            assert torch.equal(rec["state"][name], t), f"rank {rank} differs from rank 0 at {name}"


def test_world_size_one_ddp_step_equals_plain_step_bitwise():
    """DDP over a one-rank Gloo group divides by 1: parameters, moments, BatchNorm statistics and the generator equal."""
    plain = W.run_step("0.4.0")
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{_free_port()}", world_size=1, rank=0)
    try:
        model, opt = build_training(W.config("0.4.0"), TrainingArguments(seed=0, learning_rate=LR, warmup_ratio=0.0),
                                    8, device="cpu", seed=0)
        assert not isinstance(model, torch.nn.parallel.DistributedDataParallel)
        model, _ = distribute(unwrap(model), unwrap(model).mesh, ddp=True)
        assert isinstance(model, torch.nn.parallel.DistributedDataParallel)
        batch = W.TrainBatch(*(torch.from_numpy(np.ascontiguousarray(a)) for a in W.global_batch("0.4.0")))
        gen = torch.Generator().manual_seed(0)
        loss, _ = W.micro_step(model, opt, batch, gen)
        W.apply_step(opt, 1)
    finally:
        dist.destroy_process_group()
    assert torch.equal(loss, plain["loss"])
    assert torch.equal(gen.get_state(), plain["rng"])
    state = unwrap(model).state_dict()
    assert set(state) == set(plain["state"])
    for name, t in plain["state"].items():
        assert torch.equal(state[name], t), name
    moments = opt.state_dict()["state"]
    assert set(moments) == set(plain["moments"])
    for name, st in plain["moments"].items():
        assert all(torch.equal(moments[name][k], v) for k, v in st.items()), name


def test_initialize_from_torchrun_environment(monkeypatch):
    """Nothing in a single process; Gloo for the CPU; NCCL without CUDA raises instead of falling back to Gloo."""
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    assert initialize() is False and not dist.is_initialized()
    for k, v in {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0", "MASTER_ADDR": "localhost",
                 "MASTER_PORT": str(_free_port())}.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="NCCL backend needs a CUDA device"):
        initialize()
    assert not dist.is_initialized()
    try:
        assert initialize(device="cpu") is True
        assert dist.get_backend() == "gloo" and dist.get_world_size() == 1
        assert make_mesh(device="cpu").grid.tolist() == [[0]]
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("kw", [{"num_devices": 2}, {"num_devices": 4, "model_parallel_size": 2},
                                {"model_parallel_size": 2}])
def test_mesh_other_than_the_process_group_raises(kw):
    """One process per device: num_devices must be the world size (1 here), and divide by the model width."""
    with pytest.raises(ValueError, match="num_devices|not divisible"):
        build_training(ModelConfig.tiny(num_labels=3, version="0.4.0"), TrainingArguments(**kw), 4, device="cpu")
    with pytest.raises(ValueError):
        make_mesh(**{"num_devices": kw.get("num_devices"), "model_axis": kw.get("model_parallel_size", 1)},
                  device="cpu")
