"""The benchmark of the port (`rgbdseg_torch`): one cell, one run.

Everything about a cell is found by name from `BENCHMARK.json`: its
configuration's file (`configs/`), its traffic mix (`traffic/<name>.json`,
whose "kind" names the loop below that drives it), its limits
(`limits/<workload>.json`), the readers of its per-layer metrics
(`metrics/<metric>.py`), the hand kernels' roofline formulas
(`roofline/<op>.py`) and the spans (`spans.json`).

A train cell builds the port's model from the benchmark's weights, drives it
through three steps from the seed (set-up, and the steps the reference
follows), then calls `trainer.put_batch` and `trainer.train_step` back to back
over a ring of distinct batches for the window, which ends in one fetch of the
last loss. An eval cell warms `trainer.evaluate` on two batches, then calls it
once over a stream that cycles a ring of batches until the window's time is
up; `flush` and `compute` fall inside the window. With `trace`, after the
window, spans wrap the port's functions and the profiler covers a steady
stretch: three more steps, or four batches of one more `evaluate` call.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib.util
import json
import time
from pathlib import Path

import numpy as np
import torch

from . import check, inputs, peaks, weights
from .reference.config import Config
from .reference.model import Mask2Former
from .trace import Profile, Reading, Spans, backward_span

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
TRACE_FROM = 2  # the traced eval stretch starts at this batch of its stream
TRACE_STEPS = {"train": 3, "eval": 4}  # steps or batches in the traced stretch, after the window


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config: dict
    traffic_name: str
    traffic: dict
    limits: dict | None
    end_to_end: list
    per_layer: list


def load_cell(workload: str, root: Path = ROOT) -> Cell:
    """The cell named `workload` of `root/BENCHMARK.json`, its files read from
    `root`'s copy of this folder."""
    bench = root / BENCH.name
    spec = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json: {sorted(cells)}")
    w = cells[workload]
    cfg = {c["name"]: c for c in spec["configs"]}[w["config"]]
    limits_path = bench / "limits" / f"{workload}.json"

    def applies(m):
        return workload in m.get("workloads", [workload])

    return Cell(
        name=workload, chips=w["chips"], config_name=w["config"], config=json.loads((root / cfg["file"]).read_text()),
        traffic_name=w["traffic"], traffic=json.loads((bench / "traffic" / f"{w['traffic']}.json").read_text()),
        limits=json.loads(limits_path.read_text()) if limits_path.exists() else None,
        end_to_end=[m for m in spec["end_to_end"] if applies(m)],
        per_layer=[m for m in spec["per_layer"] if applies(m)],
    )


def load_module(path: Path):
    spec = importlib.util.spec_from_file_location(f"benchmark_{path.parent.name}_{path.stem.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def roofline_ops() -> dict:
    return {p.stem: load_module(p) for p in sorted((BENCH / "roofline").glob("*.py"))}


def metric_reader(name: str, root: Path = ROOT):
    return load_module(root / BENCH.name / "metrics" / f"{name}.py")


def model_configs(config: dict):
    """(the port's ModelConfig, the reference's Config) of a configuration file."""
    from rgbdseg_torch.config import ModelConfig

    return ModelConfig.from_json(json.dumps(config)), Config.from_dict(config)


def _ring(cell: Cell, seed: int, n_batches: int):
    tr = cell.traffic
    return inputs.batches(seed, n_batches, tr["batch"], tuple(tr["hw"]), tr["slots"], tr["instances"],
                          cell.config["num_labels"], cell.config["version"] != "0.0.0")


def _host(b):
    from rgbdseg_torch.data.pipeline import Batch

    return Batch(b["frames"], b["masks"], b["classes"], b["valid"], mask_labels_packed=b["packed"])


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


@dataclasses.dataclass
class Run:
    """What one run measured and read, for the result line and the readers."""

    cell: Cell
    device: torch.device
    setup_s: float = 0.0
    window_s: float = 0.0
    steps: int = 0
    images: int = 0
    failed: int = 0
    memory_peak: int = 0
    numbers: dict = dataclasses.field(default_factory=dict)
    reading: Reading | None = None
    flops_per_step: float | None = None
    build: dict = dataclasses.field(default_factory=lambda: {"sources_built": 0, "seconds": 0.0})
    extra: dict = dataclasses.field(default_factory=dict)


def _weights(rcfg, seed, device):
    with torch.device("meta"):
        meta = Mask2Former(rcfg)
    return weights.init_state(meta, seed, device)


def _port_model(pcfg, state, device):
    from rgbdseg_torch.models.mask2former import Mask2FormerRGBD

    with torch.device(device):
        model = Mask2FormerRGBD(pcfg)
    model.load_state_dict(state)
    return model.to(device)


def _build_kernels(run: Run):
    """The port's kernels built (nvcc, in a checkout's first run) or found in
    `build/kernels/`, first thing in set-up; `run.build` says which, and how long it took."""
    if run.device.type != "cuda":
        return
    from rgbdseg_torch.ops import kernels as K

    before = set(K.BUILD_DIR.glob("*.so"))
    seconds = K.build_all()
    run.build = {"sources_built": len(set(K.BUILD_DIR.glob("*.so")) - before), "seconds": seconds}


def run_train(cell: Cell, seed: int, seconds: float, trace: bool, device, t_start: float, faults=()) -> Run:
    from rgbdseg_torch.config import PreprocessConfig
    from rgbdseg_torch.train import trainer as T
    from rgbdseg_torch.train.arguments import TrainingArguments

    tr = cell.traffic
    device = torch.device(device)
    run = Run(cell, device)
    _build_kernels(run)
    pcfg, rcfg = model_configs(cell.config)
    args = TrainingArguments(per_device_train_batch_size=tr["batch"], learning_rate=tr["learning_rate"],
                             bf16=tr["bf16"], num_train_epochs=tr["epochs"], instance_bucket_floor=tr["bucket_floor"])
    T.set_matmul_precision(args.matmul_precision)
    state = _weights(rcfg, seed, device)
    model = _port_model(pcfg, state, device).train()
    opt = T.make_optimizer(model, args, tr["epoch_examples"])
    ring = _ring(cell, seed, tr["ring"])
    host = [_host(b) for b in ring]
    pp = PreprocessConfig(height=tr["hw"][0], width=tr["hw"][1])
    gen = torch.Generator(device=device).manual_seed(int(seed))
    if "unchanged" in faults:  # the fault whose steps return the state unchanged
        opt.step = lambda closure=None: torch.zeros((), device=device)

    def put(batch, a, d):
        tb = T.put_batch(batch, a, d)
        if "half_batch" in faults:  # the fault that leaves half of each batch out
            tb = type(tb)(*(x[: x.shape[0] // 2] for x in tb))
        return tb

    losses, grad = [], {}
    for i in range(3):  # set-up: the first steps, which the reference follows
        loss, _, _ = T.train_step(model, opt, put(host[i], args, device), gen, pp)
        losses.append(loss)
        if i == 0:  # the first gradient as the optimizer got it: its first moment over 1 - beta1
            grad = {n: torch.linalg.vector_norm(opt.state[p]["mu"]) / (1 - args.adam_beta1) if opt.state[p]
                    else torch.zeros((), device=device) for p, n in opt.names.items()}
    change = {n: torch.linalg.vector_norm(p.detach() - state[n]) for n, p in model.named_parameters()}
    prog = {"losses": [x.item() for x in losses], "grad": {n: v.item() for n, v in grad.items()},
            "change": {n: v.item() for n, v in change.items()}}
    total_steps = opt.total_steps

    _sync(device)
    run.setup_s = time.time() - t_start
    run.extra["setup_s"] = run.setup_s
    window_losses, i = [], 3
    t0 = time.perf_counter()
    while not window_losses or time.perf_counter() - t0 < seconds:
        loss, _, _ = T.train_step(model, opt, put(host[i % len(host)], args, device), gen, pp)
        window_losses.append(loss)
        i += 1
    window_losses[-1].item()  # the window ends in one value fetch
    run.window_s = time.perf_counter() - t0
    n = len(window_losses)
    run.steps, run.images = n, n * tr["batch"]
    run.failed = int((~torch.isfinite(torch.stack(window_losses))).sum().item())
    run.memory_peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    if trace:  # a steady stretch after the window, traced
        with _traced(run, "train", device) as record:
            for _ in range(TRACE_STEPS["train"]):
                T.train_step(model, opt, put(host[i % len(host)], args, device), gen, pp)
                i += 1
            record()
    del model, opt, losses, window_losses, loss
    _free(device)
    ref = check.reference_train(rcfg, state, ring, seed, device, tr, total_steps)
    run.numbers = check.train_numbers(prog, ref)
    run.extra["losses"] = (prog["losses"], ref["losses"])
    run.extra["worst_leaves"] = check.worst_leaves(prog, ref)
    if trace:
        from . import flops

        run.flops_per_step = flops.train_step(rcfg, state, ring[0], tr, device)
    return run


def run_eval(cell: Cell, seed: int, seconds: float, trace: bool, device, t_start: float, faults=()) -> Run:
    from rgbdseg_torch.config import PreprocessConfig
    from rgbdseg_torch.train import evaluator as E
    from rgbdseg_torch.train import trainer as T

    tr = cell.traffic
    device = torch.device(device)
    run = Run(cell, device)
    _build_kernels(run)
    pcfg, rcfg = model_configs(cell.config)
    T.set_matmul_precision(tr.get("matmul_precision", "float32"))
    state = _weights(rcfg, seed, device)
    model = _port_model(pcfg, state, device).eval()
    ring = _ring(cell, seed, tr["ring"])
    host = [_host(b) for b in ring]
    pp = PreprocessConfig(height=tr["hw"][0], width=tr["hw"][1])
    id2label = {i: f"class{i}" for i in range(cell.config["num_labels"])}
    T.evaluate(model, host[:2], id2label, pp, generator=torch.Generator(device=device).manual_seed(0),
               bf16=tr["bf16"])  # warm-up: every shape of the window, mAP included

    captured = {"logits": {}, "layers": {}, "stats": [], "forwards": 0, "compute_s": 0.0}
    update_from_stats, compute = E.Evaluator.update_from_stats, E.Evaluator.compute

    def capture_outputs(module, args, out):
        """The logits of the stream's first pass over the ring as the forward
        produces them: the final layer's, the first prediction layer's, and
        every layer's mask logits but the last (the reference derives its
        attention masks from them)."""
        j = captured["forwards"]
        captured["forwards"] += 1
        if "altered" in faults and j == 0:  # the fault that alters an answer where it is produced
            for t in (out.masks_queries_logits, out.aux_mask_logits[0]):
                t[0] *= 1.01
        if j < len(ring):
            captured["logits"][j] = tuple(t.detach().clone() for t in (
                out.class_queries_logits, out.masks_queries_logits, out.aux_class_logits[0], out.aux_mask_logits[0]))
            captured["layers"][j] = [t.detach().clone() for t in out.aux_mask_logits]

    def capture_stats(self, stats, gt_labels, gt_valid):
        captured["stats"].append(tuple(np.array(x) for x in stats))
        return update_from_stats(self, stats, gt_labels, gt_valid)

    def timed_compute(self, *args, **kwargs):
        t = time.perf_counter()
        try:
            return compute(self, *args, **kwargs)
        finally:
            captured["compute_s"] += time.perf_counter() - t

    E.Evaluator.update_from_stats, E.Evaluator.compute = capture_stats, timed_compute
    hook = model.register_forward_hook(capture_outputs)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    fed = {"batches": 0}

    def stream():
        while not fed["batches"] or time.perf_counter() - t0 < seconds:
            fed["batches"] += 1
            yield host[(fed["batches"] - 1) % len(host)]

    _sync(device)
    run.setup_s = time.time() - t_start
    run.extra["setup_s"] = run.setup_s
    try:
        t0 = time.perf_counter()
        metrics = T.evaluate(model, stream(), id2label, pp, generator=gen, bf16=tr["bf16"])
        run.window_s = time.perf_counter() - t0
    finally:
        hook.remove()
        E.Evaluator.update_from_stats, E.Evaluator.compute = update_from_stats, compute
    run.extra["compute_s"] = captured["compute_s"]
    n = fed["batches"]
    run.steps, run.images = n, n * tr["batch"]
    run.failed = 0 if np.isfinite(metrics["eval_loss"]) else n
    run.memory_peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    if trace:  # a steady stretch after the window, traced: batches 2-5 of one more evaluate call
        with _traced(run, "eval", device) as record:
            def traced_stream():
                for j in range(TRACE_FROM + TRACE_STEPS["eval"]):
                    if j == TRACE_FROM:
                        record.start()
                    yield host[j % len(host)]
                record()

            T.evaluate(model, traced_stream(), id2label, pp, generator=gen, bf16=tr["bf16"])
    prog = {"logits": captured["logits"], "stats": captured["stats"], "loss": metrics["eval_loss"],
            "map": {k: v for k, v in metrics.items()
                    if k not in ("eval_loss", "eval_runtime", "eval_samples_per_second")}}
    del model
    _free(device)
    ref = check.reference_eval(rcfg, state, ring, n, seed, device, id2label, forced=captured["layers"])
    run.numbers = check.eval_numbers(prog, ref, len(ring))
    if trace:
        from . import flops

        run.flops_per_step = flops.eval_batch(rcfg, state, ring[0], tr, device)
    return run


KINDS = {"train": run_train, "eval": run_eval}


def _free(device):
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


class _Record:
    """Starts the profiler (`start()`, or at the first call) and stops it (a call)."""

    def __init__(self, spans: Spans, prof: Profile):
        self.spans, self.prof, self.started, self.stopped = spans, prof, False, False

    def start(self):
        self.prof.start()
        self.spans.recording = self.started = True

    def __call__(self):
        if not self.started:
            self.start()
        self.spans.recording = False
        self.prof.stop()
        self.stopped = True


@contextlib.contextmanager
def _traced(run: Run, kind: str, device):
    """Spans installed for the block, which traces a stretch of `TRACE_STEPS[kind]`
    steps between `record.start()` (or the block's start) and `record()`; then
    `run.reading`, with the window's own wall time per step (the profiler slows
    the host-bound steps it traces)."""
    spans = Spans(json.loads((BENCH / "spans.json").read_text()), roofline_ops())
    prof = Profile(ROOT / "build" / "benchmark")
    record = _Record(spans, prof)
    spans.install()
    try:
        with backward_span():
            if kind == "train":
                record.start()
            yield record
    finally:
        spans.uninstall()
    events = prof.read()
    ev = next(e for e in events if e.get("name") == "bench.window" and e.get("ph") == "X")
    run.reading = Reading(events, (ev["ts"], ev["ts"] + ev["dur"]), TRACE_STEPS[kind], spans.calls,
                          run.window_s / run.steps)


def result(run: Run, trace: bool) -> dict:
    """The result line of a run (the checks last)."""
    cell = run.cell
    limits = cell.limits or {}
    correct = check.judge(run.numbers, limits)
    kind = torch.cuda.get_device_name(run.device) if run.device.type == "cuda" else "cpu"
    device = {"platform": "gpu" if run.device.type == "cuda" else "cpu", "kind": kind, "count": 1,
              "memory_peak_bytes": int(run.memory_peak)}
    line = {"correct": correct, "attempted": run.steps, "failed": run.failed, "metrics": {}, "device": device}
    if not trace:
        for m in cell.end_to_end:  # setup_s, or a rate of images (`train_img_s`, `train_img_s.bf16`, ...)
            value = run.setup_s if m["name"] == "setup_s" else run.images / run.window_s
            line["metrics"][m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        device["busy_s"] = run.reading.busy_us() / 1e6
        device["window_s"] = run.reading.window_us() / 1e6
        for m in cell.per_layer:
            value = metric_reader(m["name"]).read(run)
            if value is not None:
                line["metrics"][m["name"]] = {"value": value, "unit": m["unit"]}
        line["breakdown"] = {"device_ops": run.reading.top_device_ops(), "idle_gaps": run.reading.idle_gaps()}
    line["kernel_build"] = run.build
    compared = [k for k in run.numbers if k in limits] if limits else list(run.numbers)
    line["checks"] = {k: {"value": run.numbers[k], "limit": limits.get(k)} for k in compared}
    return line


def peaks_of(run: Run):
    return peaks.for_device(torch.cuda.get_device_name(run.device)) if run.device.type == "cuda" else None
