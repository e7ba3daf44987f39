"""One parallel train step of the tiny port model, run in each of several Gloo
processes on the CPU by `tests/test_torch_parallel.py` (and as the
one-process reference at the global batch, in the test's own process); or,
with `--eval` in place of the version, the eval and predict of
`tests/test_torch_parallel_eval.py` (`run_eval`).

    RANK=r WORLD_SIZE=n MASTER_ADDR=localhost MASTER_PORT=p \\
        python tests/torch_parallel_worker.py VERSION|--eval MODEL_PARALLEL OUT_DIR

Every rank builds the same seeded model and global batch, takes its rows
(`host_row_range`), and runs one `micro_step` + `apply_step` over the mesh
(`build_training`: sharded over the model group, DDP over the data group).
It writes `rank{r}.pt`: the loss, the gradient norm, every gradient (a
shard's gathered to its full tensor), the BatchNorm running statistics and
the updated state_dict (full tensors), the moments and the generator's state. It imports neither JAX nor the JAX
package, so the processes start fast.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from rgbdseg_torch import versions as TV  # noqa: E402
from rgbdseg_torch.config import ModelConfig  # noqa: E402
from rgbdseg_torch.data.pipeline import Batch  # noqa: E402
from rgbdseg_torch.models.mask2former import Mask2FormerRGBD  # noqa: E402
from rgbdseg_torch.parallel.multihost import host_row_range, initialize  # noqa: E402
from rgbdseg_torch.parallel.sharding import full_state_dict, gather_shard  # noqa: E402
from rgbdseg_torch.train.arguments import TrainingArguments  # noqa: E402
from rgbdseg_torch.train.trainer import (  # noqa: E402
    TrainBatch, apply_step, build_training, evaluate, micro_step, predict, unwrap)
from rgbdseg_torch.utils.weights import init_weights  # noqa: E402

HW, T, NUM_LABELS, GLOBAL_B = 64, 4, 3, 2
EVAL_N = 3  # eval examples: the second global batch holds one, padded
ID2LABEL = {i: f"class{i}" for i in range(NUM_LABELS)}


def config(version: str) -> ModelConfig:
    """The tiny model with drop path on, so that its draws are exercised too."""
    cfg = ModelConfig.tiny(num_labels=NUM_LABELS, version=version)
    return cfg.replace(backbone=dataclasses.replace(cfg.backbone, drop_path_rate=0.2))


def global_batch(version: str, seed: int = 0):
    """(stack, masks, classes, valid) of GLOBAL_B rows from seeded numpy."""
    spec = TV.get(version).channels
    rng = np.random.RandomState(seed)
    x = rng.randn(GLOBAL_B, HW, HW, spec.total).astype(np.float32)
    for group in ("depth", "fused_depth"):
        if getattr(spec, group) is not None:
            lo, hi = getattr(spec, group)
            x[..., lo:hi] = rng.uniform(-2, 2, (GLOBAL_B, HW, HW, hi - lo))
    if spec.gradient is not None:
        lo, hi = spec.gradient
        x[..., lo:hi] = rng.rand(GLOBAL_B, HW, HW, hi - lo)
    if spec.gradient_mask is not None:
        x[..., spec.gradient_mask[0]] = rng.rand(GLOBAL_B, HW, HW) > 0.3
    masks = np.zeros((GLOBAL_B, T, HW, HW), np.float32)
    for b in range(GLOBAL_B):
        for t in range(T):
            y0, x0 = rng.randint(0, HW // 2, 2)
            masks[b, t, y0:y0 + rng.randint(8, HW // 2), x0:x0 + rng.randint(8, HW // 2)] = 1.0
    classes = rng.randint(0, NUM_LABELS, (GLOBAL_B, T)).astype(np.int64)
    valid = np.ones((GLOBAL_B, T), bool)
    valid[-1, -1] = False  # an unequal share of real instances per rank
    return x, masks, classes, valid


def run_step(version: str, model_parallel: int = 1, seed: int = 0, num_devices=None) -> dict:
    """One step over the process group (one process without one); the record described above."""
    args = TrainingArguments(num_devices=num_devices, model_parallel_size=model_parallel, seed=seed,
                             learning_rate=1e-3, warmup_ratio=0.0)
    model, opt = build_training(config(version), args, 8, device="cpu", seed=seed)
    net = unwrap(model)
    start, stop = host_row_range(GLOBAL_B, net.mesh)
    batch = TrainBatch(*(torch.from_numpy(np.ascontiguousarray(a[start:stop])) for a in global_batch(version, seed)))
    gen = torch.Generator().manual_seed(seed)
    opt.zero_grad(set_to_none=True)
    loss, _ = micro_step(model, opt, batch, gen)
    grads = {}
    for name, p in net.named_parameters():
        if p.grad is not None:
            dim = net.tp_shards.get(name)
            grads[name] = (p.grad if dim is None else gather_shard(p.grad, dim, net.mesh)).clone()
    norm = apply_step(opt, 1)
    state = {k: v.clone() for k, v in full_state_dict(net).items()}
    return {"loss": loss, "norm": norm, "grads": grads, "state": state, "rng": gen.get_state(),
            "moments": opt.state_dict()["state"], "sharded": sorted(net.tp_shards)}


def eval_batches(seed: int = 1) -> list:
    """EVAL_N examples of `global_batch` at a global batch of GLOBAL_B, the last
    chunk padded by repeating the first example (as `SegmentationDataset.batches`
    pads); the first batch's masks also bit-packed, the second's plain. The
    first T - 1 slots of each example hold the seeded model's own masks of its
    first queries (their 16x16 logits above 0, each cell 4x4 pixels) and labels,
    so that the random weights score a mAP above 0."""
    x, masks, classes, valid = (np.concatenate(a) for a in zip(global_batch("0.4.0", seed),
                                                               global_batch("0.4.0", seed + 1)))
    model = init_weights(Mask2FormerRGBD(config("0.4.0")), 0).eval()
    with torch.no_grad():
        out = model(torch.from_numpy(x[:EVAL_N]))
    own = (out.masks_queries_logits[:, :T - 1] > 0).repeat_interleave(4, 2).repeat_interleave(4, 3).numpy()
    masks[:EVAL_N, :T - 1] = own
    classes[:EVAL_N, :T - 1] = out.class_queries_logits[:, :T - 1, :NUM_LABELS].argmax(-1).numpy()
    valid[:EVAL_N, :T - 1] = own.any((2, 3))
    order = [0, 1, 2, 0]
    batches = []
    for k in range(0, len(order), GLOBAL_B):
        rows = order[k:k + GLOBAL_B]
        packed = np.packbits(masks[rows].astype(bool).reshape(GLOBAL_B, T, -1), axis=-1) if k == 0 else None
        batches.append(Batch(x[rows], masks[rows], classes[rows], valid[rows], mask_labels_packed=packed))
    return batches


def run_eval(model_parallel: int = 1, num_devices=None) -> dict:
    """`evaluate` and `predict` of the seeded model over `eval_batches()`, under
    RGBDSEG_EVAL_DEVICE_STATS "1" and then "0": {switch: {"eval": metrics,
    "predict": (its logits per batch as tensors, its metrics), "lines": the
    trainer's log lines}}."""
    args = TrainingArguments(num_devices=num_devices, model_parallel_size=model_parallel, seed=0)
    model, _ = build_training(config("0.4.0"), args, EVAL_N, device="cpu", seed=0)
    batches = eval_batches()
    lines = []
    handler = logging.Handler(logging.INFO)
    handler.emit = lambda record: lines.append(record.getMessage())
    trainer_log = logging.getLogger("rgbdseg_torch.train.trainer")
    level, previous = trainer_log.level, os.environ.get("RGBDSEG_EVAL_DEVICE_STATS")
    trainer_log.addHandler(handler)
    trainer_log.setLevel(logging.INFO)
    rec = {}
    try:
        for switch in ("1", "0"):
            os.environ["RGBDSEG_EVAL_DEVICE_STATS"] = switch
            lines.clear()
            metrics = evaluate(model, batches, ID2LABEL, generator=torch.Generator().manual_seed(0),
                               num_examples=EVAL_N)
            logits, predicted = predict(model, batches, ID2LABEL, num_examples=EVAL_N,
                                        generator=torch.Generator().manual_seed(0))
            rec[switch] = {"eval": metrics, "lines": list(lines),
                           "predict": ([tuple(torch.from_numpy(a) for a in b) for b in logits], predicted)}
    finally:
        trainer_log.removeHandler(handler)
        trainer_log.setLevel(level)
        if previous is None:
            os.environ.pop("RGBDSEG_EVAL_DEVICE_STATS", None)
        else:
            os.environ["RGBDSEG_EVAL_DEVICE_STATS"] = previous
    return rec


if __name__ == "__main__":
    version, mp, out_dir = sys.argv[1], int(sys.argv[2]), sys.argv[3]
    torch.set_num_threads(1)
    initialize(device="cpu")
    if version == "--eval":
        rec = run_eval(mp, num_devices=int(os.environ["WORLD_SIZE"]))
    else:
        rec = run_step(version, mp, num_devices=int(os.environ["WORLD_SIZE"]))
    torch.save(rec, os.path.join(out_dir, f"rank{os.environ['RANK']}.pt"))
    torch.distributed.destroy_process_group()
