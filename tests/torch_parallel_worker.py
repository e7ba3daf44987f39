"""One parallel train step of the tiny port model, run in each of several Gloo
processes on the CPU by `tests/test_torch_parallel.py` (and as the
one-process reference at the global batch, in the test's own process).

    RANK=r WORLD_SIZE=n MASTER_ADDR=localhost MASTER_PORT=p \\
        python tests/torch_parallel_worker.py VERSION MODEL_PARALLEL OUT_DIR

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
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from rgbdseg_torch import versions as TV  # noqa: E402
from rgbdseg_torch.config import ModelConfig  # noqa: E402
from rgbdseg_torch.parallel.multihost import host_row_range, initialize  # noqa: E402
from rgbdseg_torch.parallel.sharding import full_state_dict, gather_shard  # noqa: E402
from rgbdseg_torch.train.arguments import TrainingArguments  # noqa: E402
from rgbdseg_torch.train.trainer import TrainBatch, apply_step, build_training, micro_step, unwrap  # noqa: E402

HW, T, NUM_LABELS, GLOBAL_B = 64, 4, 3, 2


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


if __name__ == "__main__":
    version, mp, out_dir = sys.argv[1], int(sys.argv[2]), sys.argv[3]
    torch.set_num_threads(1)
    initialize(device="cpu")
    rec = run_step(version, mp, num_devices=int(os.environ["WORLD_SIZE"]))
    torch.save(rec, os.path.join(out_dir, f"rank{os.environ['RANK']}.pt"))
    torch.distributed.destroy_process_group()
