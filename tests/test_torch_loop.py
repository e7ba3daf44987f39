"""The port's dataset and epoch loop against the JAX package, on the CPU.

- `rgbdseg_torch.data.synthetic.generate` (no cv2) writes files that decode to
  the JAX generator's arrays bit for bit, for the seeds and sizes the fixtures
  use, circles and modality images included.
- `SegmentationDataset.batches` gives the JAX dataset's batches on the same
  files bit for bit: the order, the padding of the last chunk, the pixels
  (raw frames under `device_channels`, else the float stacks of the port's
  channel builder against the JAX host builders), the masks, classes, valid
  slots, packed masks and original sizes.
- The epoch loop (`train.trainer.Trainer`): a resumed run equals the
  uninterrupted one bit for bit with dropout and drop path on; the epoch-end
  remainder is applied on its own count; checkpoints are pruned to
  `save_total_limit`, and `find_last_checkpoint` guards a non-empty directory
  as the JAX package does; the keys of trainer_state.json, of its log_history
  entries and of all_results.json are those of the JAX run in
  `artifacts/overfit/`.
"""

import dataclasses
import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch

from rgbdseg_tpu.config import PreprocessConfig as JPreprocessConfig
from rgbdseg_tpu.data import pipeline as JP
from rgbdseg_tpu.data import synthetic as JS
from rgbdseg_tpu.train import checkpoints as JC
from rgbdseg_torch.config import ModelConfig, PreprocessConfig
from rgbdseg_torch.data import image_io
from rgbdseg_torch.data import pipeline as TP
from rgbdseg_torch.data import synthetic as TS
from rgbdseg_torch.train import checkpoints as TC
from rgbdseg_torch.train.arguments import TrainingArguments
from rgbdseg_torch.train.trainer import Trainer, apply_step, micro_step, put_batch
from rgbdseg_torch.utils.weights import init_weights

REPO = Path(__file__).resolve().parents[1]
ID2LABEL = {0: "background", 1: "box", 2: "ball"}


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """The tiny models gain nothing from torch's intra-op pool, whose barriers
    cost the most when the suite's workers share the cores (the resume test
    took 103 s beside five busy processes with 8 threads, 31 s with 1)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _decoded(root: str, meta: str) -> list:
    with open(os.path.join(root, meta)) as f:
        records = json.load(f)
    return [[image_io.read_png(os.path.join(root, p)) for p in r["image"] + [r["annotation"]]] for r in records]


@pytest.mark.parametrize(
    "seed,size,num_modalities",
    [(0, (96, 128), 0), (0, (96, 128), 8), (3, (64, 64), 0), (5, (64, 64), 0), (5, (256, 256), 0),
     (7, (64, 64), 0), (11, (64, 64), 0), (0, (32, 40), 0)],
)
def test_synthetic_files_decode_as_jax(tmp_path, seed, size, num_modalities):
    kw = dict(num_train=3, num_valid=2, size=size, seed=seed, num_modalities=num_modalities)
    JS.generate(str(tmp_path / "jax"), **kw)
    TS.generate(str(tmp_path / "port"), **kw)
    for meta in ("train.json", "valid.json", "label2id.json"):
        assert (tmp_path / "port" / meta).read_text() == (tmp_path / "jax" / meta).read_text()
    for meta in ("train.json", "valid.json"):
        for w, g in zip(_decoded(str(tmp_path / "jax"), meta), _decoded(str(tmp_path / "port"), meta)):
            assert len(w) == len(g)
            for a, b in zip(w, g):
                assert a.dtype == b.dtype and a.shape == b.shape
                np.testing.assert_array_equal(a, b)


def test_synthetic_draws_circles_and_boxes_as_cv2():
    cv2 = pytest.importorskip("cv2")
    rng = np.random.RandomState(1)
    for _ in range(400):
        h, w = rng.randint(1, 50, 2)
        (cx, cy), r = rng.randint(-20, 70, 2), int(rng.randint(0, 40))
        a, b = np.zeros((h, w), np.uint8), np.zeros((h, w), np.uint8)
        cv2.circle(a, (int(cx), int(cy)), r, 1, -1)
        TS.fill_circle(b, (cx, cy), r, 1)
        np.testing.assert_array_equal(a, b)
        p0, p1 = rng.randint(-20, 70, 2), rng.randint(-20, 70, 2)
        a[:], b[:] = 0, 0
        cv2.rectangle(a, (int(p0[0]), int(p0[1])), (int(p1[0]), int(p1[1])), 1, -1)
        TS.fill_rectangle(b, p0, p1, 1)
        np.testing.assert_array_equal(a, b)
    d = np.arange(256, dtype=np.uint8).reshape(16, 16)
    for alpha, beta in ((1.1, 5), (1.7, 35), (0.35, -2.5), (2.5, 0.5)):
        np.testing.assert_array_equal(TS.convert_scale_abs(d, alpha, beta), cv2.convertScaleAbs(d, alpha=alpha, beta=beta))
    x, y = (rng.randint(0, 256, (20, 20, 3)).astype(np.uint8) for _ in range(2))
    np.testing.assert_array_equal(TS.add_saturate(x, y), cv2.add(x, y))


def test_png_size_reads_the_header(tmp_path):
    image_io.write_png(str(tmp_path / "a.png"), np.zeros((7, 13, 3), np.uint8))
    assert image_io.png_size(str(tmp_path / "a.png")) == (7, 13)
    (tmp_path / "b.png").write_bytes(b"not a png at all, long enough")
    with pytest.raises(ValueError, match="not a PNG"):
        image_io.png_size(str(tmp_path / "b.png"))


@pytest.fixture(scope="module")
def jax_files(tmp_path_factory):
    """5 train examples of the JAX generator (an odd count: the last batch of 2 is padded)."""
    root = tmp_path_factory.mktemp("set")
    return JS.generate(str(root), num_train=5, num_valid=2, size=(48, 64), seed=7)


@pytest.mark.parametrize("device_channels", [True, False], ids=["raw_frames", "host_stacks"])
@pytest.mark.parametrize("shuffle,epoch", [(False, 0), (True, 0), (True, 3)])
def test_dataset_batches_equal_jax(jax_files, device_channels, shuffle, epoch):
    hw = dict(height=64, width=96)
    jds = JP.SegmentationDataset(JP.load_meta(jax_files["train"], jax_files["root"]), "0.4.0",
                                 JPreprocessConfig(**hw), max_instances=6, device_channels=device_channels)
    tds = TP.SegmentationDataset(TP.load_meta(jax_files["train"], jax_files["root"]), "0.4.0",
                                 PreprocessConfig(**hw), max_instances=6, device_channels=device_channels)
    assert jds.device_channels == tds.device_channels == device_channels
    jds.pack_gt = tds.pack_gt = True
    kw = dict(shuffle=shuffle, seed=42, epoch=epoch, num_workers=2)
    want, got = list(jds.batches(2, **kw)), list(tds.batches(2, **kw))
    assert len(want) == len(got) == 3
    for w, g in zip(want, got):
        for f in ("mask_labels", "class_labels", "valid", "orig_sizes", "mask_labels_packed"):
            a, b = getattr(w, f), getattr(g, f)
            assert a.dtype == b.dtype and a.shape == b.shape, f
            np.testing.assert_array_equal(a, b, err_msg=f)
        assert w.pixel_values.dtype == g.pixel_values.dtype and w.pixel_values.shape == g.pixel_values.shape
        np.testing.assert_array_equal(w.pixel_values, g.pixel_values)
    assert [tds.original_size(i) for i in range(len(tds))] == [jds.original_size(i) for i in range(len(jds))]
    np.testing.assert_array_equal(tds.original_rgb(2), jds.original_rgb(2))


def test_build_datasets_as_jax(jax_files):
    from rgbdseg_tpu.train.arguments import Arguments as JArguments
    from rgbdseg_torch.train.arguments import Arguments

    kw = dict(root_path=jax_files["root"], image_height=48, image_width=64, version="0.4.0", max_instances=5)
    for reduce in (False, True):
        jtr, jva, jl2i, ji2l = JP.build_datasets(JArguments(do_reduce_labels=reduce, **kw))
        ttr, tva, tl2i, ti2l = TP.build_datasets(Arguments(do_reduce_labels=reduce, **kw))
        assert (tl2i, ti2l) == (jl2i, ji2l)
        assert (len(ttr), len(tva), ttr.device_channels, tva.max_instances) == \
            (len(jtr), len(jva), jtr.device_channels, jva.max_instances)
        assert ttr.preprocess.do_reduce_labels == reduce and ttr.records == jtr.records


# ------------------------------------------------------------------ the loop


@pytest.fixture(scope="module")
def port_set(tmp_path_factory):
    root = tmp_path_factory.mktemp("loop")
    fx = TS.generate(str(root), num_train=4, num_valid=2, size=(64, 64), seed=3)
    pp = PreprocessConfig(height=64, width=64)
    return (TP.SegmentationDataset(TP.load_meta(fx["train"], fx["root"]), "0.4.0", pp, max_instances=6,
                                   device_channels=True),
            TP.SegmentationDataset(TP.load_meta(fx["valid"], fx["root"]), "0.4.0", pp, max_instances=6,
                                   device_channels=True))


def _stochastic_tiny():
    """The tiny 0.4.0 model with dropout and drop path on."""
    cfg = ModelConfig.tiny(num_labels=3, version="0.4.0")
    return cfg.replace(dropout=0.1, backbone=dataclasses.replace(cfg.backbone, drop_path_rate=0.3))


def _args(out, **kw):
    base = dict(output_dir=str(out), num_train_epochs=4, per_device_train_batch_size=2, learning_rate=5e-4,
                weight_decay=0.05, warmup_ratio=0.25, seed=42, do_eval=False, dataloader_num_workers=2,
                save_total_limit=None)
    base.update(kw)
    return TrainingArguments(**base)


def test_resume_equals_uninterrupted_run_bitwise(port_set, tmp_path):
    """4 epochs straight == 2 epochs + checkpoint + a fresh Trainer + 2 epochs:
    parameters, BatchNorm statistics, moments, count and generator state."""
    train_ds, valid_ds = port_set
    cfg = _stochastic_tiny()
    a = Trainer(cfg, _args(tmp_path / "a"), train_ds, valid_ds, ID2LABEL, device="cpu")
    a.train()
    assert a.global_step == 8

    out_b = tmp_path / "b"
    b1 = Trainer(cfg, _args(out_b), train_ds, valid_ds, ID2LABEL, device="cpu")
    save = b1._save

    def interrupting_save(output_dir):
        save(output_dir)
        if b1.global_step == 4:
            raise KeyboardInterrupt

    b1._save = interrupting_save
    with pytest.raises(KeyboardInterrupt):
        b1.train()
    last = TC.find_last_checkpoint(str(out_b))
    assert last.endswith("checkpoint-4")
    b2 = Trainer(cfg, _args(out_b), train_ds, valid_ds, ID2LABEL, device="cpu")
    b2.train(resume_from_checkpoint=last)

    assert b2.global_step == a.global_step == b2.optimizer.count == a.optimizer.count
    sa, sb = a.model.state_dict(), b2.model.state_dict()
    assert sa.keys() == sb.keys() and any("running_mean" in k for k in sa)
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
    oa, ob = a.optimizer.state_dict(), b2.optimizer.state_dict()
    assert oa["state"].keys() == ob["state"].keys()
    for n in oa["state"]:
        for m in ("mu", "nu"):
            assert torch.equal(oa["state"][n][m], ob["state"][n][m]), (n, m)
    assert torch.equal(a.generator.get_state(), b2.generator.get_state())
    assert [e["loss"] for e in a.log_history[2:]] == [e["loss"] for e in b2.log_history]


def test_checkpoint_reload_is_exact_and_partial(port_set, tmp_path):
    train_ds, valid_ds = port_set
    t = Trainer(_stochastic_tiny(), _args(tmp_path, num_train_epochs=1), train_ds, valid_ds, ID2LABEL, device="cpu")
    t.train()
    path = TC.find_last_checkpoint(str(tmp_path))
    assert sorted(os.listdir(path)) == ["model.pt", "trainer.pt"]
    fresh = Trainer(_stochastic_tiny(), _args(tmp_path, num_train_epochs=1), train_ds, valid_ds, ID2LABEL,
                    device="cpu")
    fresh._restore(path)
    assert fresh.global_step == 2 and fresh.optimizer.count == 2
    for k, v in t.model.state_dict().items():
        assert torch.equal(fresh.model.state_dict()[k], v), k
    assert torch.equal(fresh.generator.get_state(), t.generator.get_state())
    partial = TC.load_checkpoint_partial(path)
    assert partial.keys() == t.model.state_dict().keys()
    with pytest.raises(ValueError, match="does not match"):
        fresh.optimizer.load_state_dict({"count": 1, "state": {"nope": {}}})


def test_epoch_end_remainder_is_applied_on_its_own_count(port_set, tmp_path):
    """3 micro-batches with gradient_accumulation_steps=2: one step on the mean
    of 2, then one on the remainder alone, as the JAX loop's :685-692."""
    train_ds, _ = port_set
    ds = TP.SegmentationDataset(train_ds.records[:3], "0.4.0", train_ds.preprocess, max_instances=6,
                                device_channels=True)
    cfg = _stochastic_tiny()
    args = _args(tmp_path, num_train_epochs=1, per_device_train_batch_size=1, gradient_accumulation_steps=2)
    t = Trainer(cfg, args, ds, None, ID2LABEL, device="cpu")
    t.train()
    assert t.global_step == t.optimizer.count == 2 == t.total_steps
    assert t.log_history[0]["step"] == 2

    # the same composition by hand
    ref = Trainer(cfg, args, ds, None, ID2LABEL, device="cpu")
    ds.pack_gt = True
    batches = [put_batch(b, args, "cpu") for b in ds.batches(1, shuffle=True, seed=args.seed, epoch=0)]
    for i, b in enumerate(batches):
        micro_step(ref.model, ref.optimizer, b, ref.generator, ds.preprocess)
        if i == 1:
            apply_step(ref.optimizer, 2)
    apply_step(ref.optimizer, 1)
    for k, v in ref.model.state_dict().items():
        assert torch.equal(t.model.state_dict()[k], v), k


def test_checkpoints_pruned_and_guard_as_jax(tmp_path):
    model = init_weights(torch.nn.Linear(3, 2), 0)
    from rgbdseg_torch.train.optim import AdamW

    opt = AdamW(model.named_parameters(), TrainingArguments(), 10)
    gen = torch.Generator().manual_seed(0)
    for step in (3, 6, 9):
        TC.save_checkpoint(str(tmp_path), step, model, opt, gen, save_total_limit=2)
    assert sorted(os.listdir(tmp_path)) == ["checkpoint-6", "checkpoint-9"]
    assert TC.find_last_checkpoint(str(tmp_path)) == str(tmp_path / "checkpoint-9")
    assert TC.find_last_checkpoint(str(tmp_path / "missing")) is None

    busy = tmp_path / "busy"
    busy.mkdir()
    (busy / "notes.txt").write_text("x")
    with pytest.raises(ValueError) as want:
        JC.find_last_checkpoint(str(busy))
    with pytest.raises(ValueError) as got:
        TC.find_last_checkpoint(str(busy))
    assert str(got.value) == str(want.value)
    assert TC.find_last_checkpoint(str(busy), overwrite=True) is None


def test_artifact_keys_equal_the_jax_runs(tmp_path):
    """A tiny run of the port's learning-proof tool writes the JAX run's files
    with the JAX run's keys and its curve PNGs (artifacts/overfit/)."""
    from rgbdseg_torch.tools import overfit_run

    out = tmp_path / "overfit"
    overfit_run.main(["--output", str(out), "--size", "64", "--epochs", "1", "--tiny", "--device", "cpu",
                      "--num_images", "4"])
    ref = REPO / "artifacts" / "overfit"
    for name in ("trainer_state.json", "all_results.json", "train_results.json", "test_results.json"):
        got, want = json.loads((out / name).read_text()), json.loads((ref / name).read_text())
        assert got.keys() == want.keys(), name
    got = json.loads((out / "trainer_state.json").read_text())["log_history"]
    want = json.loads((ref / "trainer_state.json").read_text())["log_history"]
    assert [e.keys() for e in got] == [e.keys() for e in want[:2]]
    assert sorted(p.name for p in out.glob("*.png")) == sorted(p.name for p in ref.glob("*.png"))
    assert "curves in training_metrics.png" in (out / "README.md").read_text()


def test_profiler_traces_the_chosen_steps(port_set, tmp_path):
    train_ds, _ = port_set
    args = _args(tmp_path, num_train_epochs=1, profile_start_step=0, profile_stop_step=1)
    Trainer(ModelConfig.tiny(num_labels=3, version="0.4.0"), args, train_ds, None, ID2LABEL, device="cpu").train()
    trace = json.loads((tmp_path / "profile" / "trace.json").read_text())
    names = {e.get("name", "") for e in trace["traceEvents"]}
    assert any("convolution" in n for n in names)
