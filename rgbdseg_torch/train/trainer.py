"""The train step, evaluation and prediction (counterparts of the train step
of `rgbdseg_tpu/train/trainer.py`: `_loss_grads`, `_train_step_fn`,
`_accum_step_fn`, `_apply_step_fn`, `_put`, `_cast_bf16`, and of
`Trainer.evaluate`, `Trainer.predict` and `save_metrics`).

- `put_batch` ships a host `data.pipeline.Batch` to the device as the JAX
  `_put` does on one process: the targets compacted to their power-of-two
  bucket under `compact_instances`, the bit-packed masks shipped under
  `pack_targets`, raw uint8 frames as they are.
- `micro_step` runs the forward in train mode (drop path, dropout, BatchNorm on
  batch statistics and its running-stat update), the Mask2Former criterion
  over every prediction layer and the backward (through the K1 and K3
  backward kernels on the card), and adds the gradients to each parameter's
  float32 `.grad`. Raw uint8 frames are built into the channel stack on the
  device (`device_preprocess.build_from_packed`) and bit-packed masks unpacked
  there, inside the step.
- `apply_step` divides the summed gradients by the number of micro-batches
  actually accumulated, clips and runs AdamW; `train_step` is one micro-step
  and its apply.
- Under `TrainingArguments.bf16` the forward runs on a bfloat16 copy of every
  float32 parameter and of the pixel stack (`torch.func.functional_call`), the
  outputs are cast to float32 before the loss, and the gradients flow back
  through the cast to the float32 master parameters; the optimizer state and
  the BatchNorm running statistics stay float32. The modules promote mixed
  operands as flax does (`models/layers.py`). `evaluate` and `predict` take
  the same policy.

The model runs on the device of its parameters; the batch is moved there. One
`torch.Generator` drives the dropout and drop-path masks and the criterion's
point coordinates. `build_training` applies `matmul_precision` as the JAX
Trainer does at init: float32 / bfloat16_3x / bfloat16 select torch's
"highest" / "high" / "medium" float32 matmul precision, with cuDNN's TF32
switch set to match. K3 and its backward compute 3xTF32 products whatever the
setting (`csrc/mma_tf32.cuh`).

`Trainer` (counterpart of `rgbdseg_tpu/train/trainer.py::Trainer`) composes
these into the epoch loop over a `data.pipeline.SegmentationDataset`:
the warmup-and-decay schedule over all epochs' optimizer steps, gradient
accumulation with the epoch's remainder applied on its own count, one
`log_history` entry per epoch, eval and checkpoints per epoch, an exact
resume (the model, the optimizer's moments and count, and the generator's
state are checkpointed, `train/checkpoints.py`), `torch.profiler` traces of
chosen steps, and HF-Trainer-compatible `trainer_state.json` and
`*_results.json`. `total_flos` counts each target bucket's first micro-step
under torch's `FlopCounterMode` and adds the hand kernels' operations by their
own formulas (`ops.kernels.FLOPS`), which the mode cannot see; it is not
XLA's cost analysis, which the JAX package reads.

Parallelism (counterpart of the JAX trainer's mesh, `trainer.py:113-119`,
`:161-165`, `:230-236`, `:464-525`, `:745`, `:766-866`): `Trainer` and
`build_training` lay the ranks out with `parallel.make_mesh(num_devices,
model_parallel_size)`, shard the model when `model_parallel_size` > 1
(`parallel.sharding.shard_model`) and wrap it in DistributedDataParallel over
the data group when the data width is above 1. A step then computes what one
process computes over the global batch (`per_device_train_batch_size` x the
data width), as the JAX SPMD program does: every rank loads its own rows
(`parallel.multihost.host_row_range`), the BatchNorm statistics, the loss
denominators and the random draws are the global batch's
(`parallel.mesh.active`), each rank's loss is scaled by the data width so
that DDP's mean of the gradients is the global batch's gradient, and
micro-steps other than an optimizer step's last run under `no_sync`. DDP is
built with `find_unused_parameters`: no gradient reaches the 0.4.0 backbone
or its ratio predictor, whose gradients stay None and get the optimizer's zero
and weight decay as in one process. Target compaction and packed targets are
single-process only, as in the JAX package. Eval in several processes
decodes the whole global batch on every rank and feeds the rank's rows. As in
the JAX Trainer, the IoU statistics of each rank's rows are gathered over the
data group, or, under RGBDSEG_EVAL_DEVICE_STATS=0 or for images of several
sizes evaluated at their original size, the logits are gathered for the host
mask path; either way every rank computes the same metrics. Rank 0 alone
writes files; a checkpoint holds the full tensors of a sharded model, so it
does not depend on the topology.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import logging
import math
import os
import time
from typing import Iterable, NamedTuple, Optional, Sequence

import numpy as np
import torch
from torch.nn.parallel import DistributedDataParallel

from ..config import ModelConfig, PreprocessConfig
from ..data.device_preprocess import build_from_packed, unpack_masks
from ..data.pipeline import Batch, compact_targets
from ..inference.predictor import resolve_device
from ..models.mask2former import Mask2FormerRGBD, ModelOutputs
from ..ops import kernels
from ..ops.losses import mask2former_loss
from ..parallel.mesh import Mesh, active, barrier, data_sum, gather_rows, is_main_process, make_mesh
from ..parallel.multihost import host_row_range
from ..parallel.sharding import full_state_dict, gather_shard, local_shard, shard_model
from ..utils.hf_convert import graft
from ..utils.weights import init_weights
from ..versions import get as get_version
from .arguments import TrainingArguments
from .checkpoints import load_checkpoint, write_checkpoint
from .evaluator import Evaluator
from .optim import AdamW

logger = logging.getLogger(__name__)

# TrainingArguments.matmul_precision -> torch's float32 matmul precision
MATMUL_PRECISION = {"float32": "highest", "bfloat16_3x": "high", "bfloat16": "medium"}


class TrainBatch(NamedTuple):
    # (B, H, W, C) float32 channel stack, or (B, H', W', packed_width) raw uint8 frames
    pixel_values: torch.Tensor
    # (B, T, H, W) float32 0/1, or (B, T, ceil(H*W/8)) uint8 bit-packed, padded to T instances
    mask_labels: torch.Tensor
    class_labels: torch.Tensor  # (B, T) int
    valid: torch.Tensor  # (B, T) bool: which of the T slots are real instances


def set_matmul_precision(precision: str) -> None:
    """float32 | bfloat16_3x | bfloat16 -> torch's float32 matmul precision, and
    cuDNN's TF32 switch on for all but float32."""
    if precision not in MATMUL_PRECISION:
        raise ValueError(f"matmul_precision {precision!r} is not one of {sorted(MATMUL_PRECISION)}")
    torch.set_float32_matmul_precision(MATMUL_PRECISION[precision])
    torch.backends.cudnn.allow_tf32 = precision != "float32"


def unwrap(model: torch.nn.Module) -> torch.nn.Module:
    """The model inside a DistributedDataParallel wrapper (the model itself otherwise)."""
    return model.module if isinstance(model, DistributedDataParallel) else model


def make_optimizer(model: torch.nn.Module, args: TrainingArguments, num_examples: int, data_width: int = 1) -> AdamW:
    """AdamW over all parameters, with the JAX trainer's step count: an epoch is
    ceil(ceil(examples / global batch) / gradient_accumulation_steps) optimizer
    steps, for num_train_epochs epochs; the global batch is
    per_device_train_batch_size x `data_width`. A sharded model's shards are
    named to it (their squares summed over the model group in the norm)."""
    micro = max(1, math.ceil(num_examples / (args.per_device_train_batch_size * data_width)))
    steps_per_epoch = max(1, math.ceil(micro / max(1, args.gradient_accumulation_steps)))
    total = max(1, int(steps_per_epoch * args.num_train_epochs))
    net = unwrap(model)
    mesh = getattr(net, "mesh", None)
    return AdamW(net.named_parameters(), args, total, sharded=getattr(net, "tp_shards", {}),
                 model_group=mesh.model_group if mesh is not None and mesh.model_width > 1 else None)


def distribute(model: torch.nn.Module, mesh: Mesh, ddp: Optional[bool] = None) -> tuple[torch.nn.Module, list[str]]:
    """(the model to step, the names of its sharded blocks): `model` sharded
    over the mesh's model group, then wrapped in DistributedDataParallel over
    its data group when `ddp` (default: when the data width is above 1). The
    model keeps the mesh (`model.mesh`), which the step activates."""
    blocks = shard_model(model, mesh)
    if ddp if ddp is not None else mesh.data_width > 1:
        ids = [mesh.device.index] if mesh.device.type == "cuda" else None
        model = DistributedDataParallel(model, device_ids=ids, process_group=mesh.data_group,
                                        find_unused_parameters=True, broadcast_buffers=False)
    return model, blocks


def build_training(cfg: ModelConfig, args: TrainingArguments, num_examples: int, device=None, seed: int = 0):
    """(model, optimizer): the model with the port's seeded weights on the CUDA
    device (`cuda:LOCAL_RANK`) unless `device` names another (raises without
    CUDA), in train mode, distributed over `make_mesh(args.num_devices,
    args.model_parallel_size)` (`distribute`). Applies `args.matmul_precision`."""
    mesh = make_mesh(args.num_devices, args.model_parallel_size, device)
    set_matmul_precision(args.matmul_precision)
    model, _ = distribute(init_weights(Mask2FormerRGBD(cfg), seed).to(mesh.device).train(), mesh)
    return model, make_optimizer(model, args, num_examples, mesh.data_width)


def put_batch(batch: Batch, args: TrainingArguments, device=None) -> TrainBatch:
    """Host batch -> tensors on `device` (the CUDA device unless it names
    another; raises without CUDA), as the JAX `_put` does on one process:
    targets compacted under `compact_instances`, the bit-packed masks shipped
    in place of the float ones under `pack_targets` when the batch carries them."""
    device = resolve_device(device)
    mk, cl, vd = batch.mask_labels, batch.class_labels, batch.valid
    packed = batch.mask_labels_packed if args.pack_targets else None
    if args.compact_instances:
        if packed is not None:
            mk, cl, vd, packed = compact_targets(mk, cl, vd, args.instance_bucket_floor, packed=packed)
        else:
            mk, cl, vd = compact_targets(mk, cl, vd, args.instance_bucket_floor)
    if packed is not None:
        mk = packed
    return TrainBatch(*(torch.from_numpy(np.ascontiguousarray(x)).to(device)
                        for x in (batch.pixel_values, mk, cl, np.asarray(vd, bool))))


def _inputs(model, batch: TrainBatch, preprocess: Optional[PreprocessConfig]):
    """(pixel stack, float masks, classes, valid) on the model's device: raw
    uint8 frames built into the stack, bit-packed masks unpacked at its size."""
    dev = next(model.parameters()).device
    pix = batch.pixel_values.to(dev)
    if pix.dtype == torch.uint8:
        pix = build_from_packed(get_version(model.cfg.version).map_fn, pix, preprocess or PreprocessConfig())
    masks = batch.mask_labels.to(dev)
    if masks.dtype == torch.uint8:
        masks = unpack_masks(masks, tuple(pix.shape[1:3]))
    return pix, masks, batch.class_labels.to(dev), batch.valid.to(dev)


def forward(model, pixel_values: torch.Tensor, generator: Optional[torch.Generator] = None,
            bf16: bool = False) -> ModelOutputs:
    """The model's forward; with `bf16`, on a bfloat16 copy of its float32
    parameters and of the pixels (differentiable casts, so gradients reach the
    float32 masters), the outputs cast to float32."""
    if not bf16:
        return model(pixel_values, generator)
    params = {n: p.to(torch.bfloat16) if p.dtype == torch.float32 else p for n, p in model.named_parameters()}
    out = torch.func.functional_call(model, params, (pixel_values.to(torch.bfloat16), generator))
    return ModelOutputs(out.class_queries_logits.float(), out.masks_queries_logits.float(),
                        tuple(t.float() for t in out.aux_class_logits), tuple(t.float() for t in out.aux_mask_logits))


def micro_step(model, optimizer: AdamW, batch: TrainBatch, generator: torch.Generator,
               preprocess: Optional[PreprocessConfig] = None, sync: bool = True):
    """Forward, loss and backward of one micro-batch; its gradients are added to
    each parameter's float32 `.grad`. Returns (loss, per-layer losses) as device
    tensors: the global batch's under data parallelism, where `batch` holds
    this rank's rows and `sync` False keeps the gradients local (DDP's
    `no_sync`, for all but an optimizer step's last micro-batch)."""
    net = unwrap(model)
    mesh = getattr(net, "mesh", None)
    model.train()
    quiet = model.no_sync() if isinstance(model, DistributedDataParallel) and not sync else contextlib.nullcontext()
    with active(mesh), quiet:
        pix, masks, classes, valid = _inputs(net, batch, preprocess)
        outputs = forward(model, pix, generator, optimizer.args.bf16)
        loss, per_layer = mask2former_loss(net.cfg, outputs, masks, classes, valid, generator)
        # this rank's share of the global loss; DDP averages the gradients over the data width
        (loss * mesh.data_width if mesh is not None and mesh.data_width > 1 else loss).backward()
        return data_sum(loss.detach()), {k: data_sum(v.detach()) for k, v in per_layer.items()}


def apply_step(optimizer: AdamW, count: int) -> torch.Tensor:
    """One optimizer step on the gradients summed over `count` micro-batches:
    their exact mean (an epoch's remainder divides by its own count), then clip
    and AdamW; the gradients are cleared. Returns the mean gradient's global
    norm before clipping."""
    if count > 1:
        grads = [p.grad for g in optimizer.param_groups for p in g["params"] if p.grad is not None]
        torch._foreach_div_(grads, float(count))
    grad_norm = optimizer.step()
    optimizer.zero_grad(set_to_none=True)
    return grad_norm


def train_step(model, optimizer: AdamW, batch: TrainBatch, generator: torch.Generator,
               preprocess: Optional[PreprocessConfig] = None):
    """Forward, loss, backward, clip and update on one batch. Returns (loss,
    per-layer losses, gradient norm before clipping) as device tensors."""
    optimizer.zero_grad(set_to_none=True)
    loss, per_layer = micro_step(model, optimizer, batch, generator, preprocess)
    return loss, per_layer, apply_step(optimizer, 1)


def _multi(model) -> Optional[Mesh]:
    """The model's mesh when it spans several processes, else None."""
    mesh = getattr(model, "mesh", None)
    return mesh if mesh is not None and mesh.world_size > 1 else None


def _pad_rows(batch: Batch, n: int) -> Batch:
    """A batch padded to a multiple of n rows by repeating its first row, the
    padding's targets invalid (the JAX `_put`)."""
    pad = -batch.pixel_values.shape[0] % n
    if not pad:
        return batch
    rep = {f.name: None if getattr(batch, f.name) is None else
           np.concatenate([getattr(batch, f.name), np.repeat(getattr(batch, f.name)[:1], pad, 0)])
           for f in dataclasses.fields(batch)}
    rep["valid"][-pad:] = False
    return dataclasses.replace(batch, **rep)


def _eval_outputs(model, batches: Iterable[Batch], preprocess, generator, bf16):
    """Per batch: (batch, its rows before any padding, the eval-mode outputs,
    the eval loss) on the model's device. In several processes every rank holds
    the whole global batch, padded to a multiple of the data width, feeds its
    rows (`host_row_range`), and gets the global batch's loss."""
    model = unwrap(model)
    dev = next(model.parameters()).device
    mesh = _multi(model)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    was_training = model.training
    model.eval()
    try:
        for batch in batches:
            fed, rows = batch, batch.pixel_values.shape[0]
            if mesh is not None:
                batch = _pad_rows(batch, mesh.data_width)
                fed = _rows(batch, *host_row_range(batch.pixel_values.shape[0], mesh))
            arrays = (fed.pixel_values, fed.mask_labels_packed if fed.mask_labels_packed is not None
                      else np.asarray(fed.mask_labels, np.float32), fed.class_labels, np.asarray(fed.valid, bool))
            with active(mesh):
                pix, masks, classes, valid = _inputs(
                    model, TrainBatch(*(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)), preprocess)
                out = forward(model, pix, bf16=bf16)
                loss, _ = mask2former_loss(model.cfg, out, masks, classes, valid, generator)
                loss = data_sum(loss)
            yield batch, rows, out, loss
    finally:
        model.train(was_training)


def _rows(batch: Batch, start: int, stop: Optional[int] = None) -> Batch:
    """Rows [start, stop) of a batch; `_rows(batch, n)` is its first n rows."""
    sl = slice(0, start) if stop is None else slice(start, stop)
    return dataclasses.replace(batch, **{f.name: None if getattr(batch, f.name) is None else getattr(batch, f.name)[sl]
                                         for f in dataclasses.fields(batch)})


def _update_gathered(evaluator: Evaluator, out: ModelOutputs, batch: Batch, real: int, mesh: Mesh) -> bool:
    """The several-process device-stats eval update (the JAX
    `_eval_update_multihost`): the IoU and area statistics of this rank's rows
    computed on its device (`Evaluator.device_stats_arrays`), gathered to the
    global batch's over the data group, the first `real` rows fed to the metric
    on every rank. Returns False, having done nothing, where the JAX package
    leaves the device statistics: RGBDSEG_EVAL_DEVICE_STATS other than "1", or
    an evaluation at the original size over images of several sizes."""
    if os.environ.get("RGBDSEG_EVAL_DEVICE_STATS", "1") != "1":
        return False
    b, t, gh, gw = np.shape(batch.mask_labels)
    target_hw = (gh, gw)
    if evaluator.eval_at_original_size and batch.orig_sizes is not None:
        sizes = {tuple(int(v) for v in s) for s in np.asarray(batch.orig_sizes)}
        if len(sizes) != 1:
            return False
        target_hw = sizes.pop()
    start, stop = host_row_range(b, mesh)
    gt_packed = batch.mask_labels_packed
    if gt_packed is None:
        gt_packed = np.packbits(np.asarray(batch.mask_labels).astype(bool).reshape(b, t, -1), axis=-1)
    dev = out.class_queries_logits.device
    stats = evaluator.device_stats_arrays(out.class_queries_logits, out.masks_queries_logits,
                                          gt_packed[start:stop], np.asarray(batch.valid[start:stop], bool),
                                          target_hw, (gh, gw))
    full = tuple(gather_rows(torch.from_numpy(x).to(dev), mesh)[:real].cpu().numpy() for x in stats)
    evaluator.flush()
    evaluator.update_from_stats(full, np.asarray(batch.class_labels)[:real], np.asarray(batch.valid, bool)[:real])
    logger.info("multihost eval: device-stats path (rows=%d)", real)
    return True


@torch.no_grad()
def evaluate(
    model,
    batches: Iterable[Batch],
    id2label: dict[int, str],
    preprocess: Optional[PreprocessConfig] = None,
    prefix: str = "eval_",
    generator: Optional[torch.Generator] = None,
    bf16: bool = False,
    num_examples: Optional[int] = None,
) -> dict:
    """Eval loss and mask mAP of `model` over `batches`, on the model's device.

    Each `data.pipeline.Batch` is uploaded as it is: float channel stacks, or
    raw uint8 frames (B, H, W, packed_width) built into the stack on the device
    (`device_preprocess.build_from_packed` with `preprocess`); the masks plain,
    or bit-packed in `mask_labels_packed` and unpacked there. The model runs in
    eval mode (with `bf16`, under the bf16 policy of `forward`); the loss is
    `mask2former_loss` over the whole batch with its points from `generator`
    (default: seeded 0 on the model's device); the logits stay on the device
    for `Evaluator.update`, which sees only the rows before `num_examples` (a
    last chunk padded by repetition is cut, as the JAX Trainer cuts it).
    Returns {prefix}loss (the mean over batches), the mAP keys,
    {prefix}runtime (s) and {prefix}samples_per_second."""
    evaluator = Evaluator(id2label, threshold=0.0)
    losses, n, seen = [], 0, 0
    mesh = _multi(unwrap(model))
    t0 = time.perf_counter()
    for batch, b, out, loss in _eval_outputs(model, batches, preprocess, generator, bf16):
        losses.append(loss)
        real = b if num_examples is None else max(0, min(b, num_examples - seen))
        seen += b
        if mesh is None:
            if real:
                evaluator.update(out.class_queries_logits[:real], out.masks_queries_logits[:real], _rows(batch, real))
        elif not _update_gathered(evaluator, out, batch, real, mesh):
            # the host mask path (the JAX `_host_np`): every rank gathers the
            # global batch's logits and updates the metric as one process does
            logits = [gather_rows(x, mesh)[:real] for x in (out.class_queries_logits, out.masks_queries_logits)]
            if real:
                evaluator.update(*logits, _rows(batch, real))
        n += real
    evaluator.flush()
    losses = torch.stack(losses).cpu().tolist()
    runtime = time.perf_counter() - t0
    metrics = {prefix + "loss": float(np.mean(losses))}
    metrics.update(evaluator.compute(prefix=prefix))
    metrics[prefix + "runtime"] = round(runtime, 4)
    metrics[prefix + "samples_per_second"] = round(n / max(runtime, 1e-9), 3)
    return metrics


@torch.no_grad()
def predict(
    model,
    batches: Sequence[Batch],
    id2label: dict[int, str],
    preprocess: Optional[PreprocessConfig] = None,
    prefix: str = "test_",
    num_examples: Optional[int] = None,
    bf16: bool = False,
    generator: Optional[torch.Generator] = None,
) -> tuple[list, dict]:
    """(the host logits (class (b, Q, L+1), mask (b, Q, h, w)) of each batch
    cut to its real rows, `evaluate`'s metrics over the same batches and real
    rows, its loss points from `generator`). The last batch's rows past
    `num_examples` (a chunk padded by repetition) are cut."""
    outputs, seen = [], 0
    mesh = _multi(unwrap(model))
    for _, b, out, _ in _eval_outputs(model, batches, preprocess, None, bf16):
        real = b if num_examples is None else max(0, min(b, num_examples - seen))
        logits = (out.class_queries_logits, out.masks_queries_logits)
        if mesh is not None:  # every rank gets the global batch's logits
            logits = tuple(gather_rows(x, mesh) for x in logits)
        outputs.append(tuple(x[:real].cpu().numpy() for x in logits))
        seen += b
    return outputs, evaluate(model, batches, id2label, preprocess, prefix=prefix, generator=generator, bf16=bf16,
                             num_examples=num_examples)


def save_metrics(output_dir: str, split: str, metrics: dict) -> None:
    """HF-compatible metrics JSON files ({split}_results.json and all_results.json),
    written by rank 0 alone (every rank holds the same metrics)."""
    if not is_main_process():
        return
    os.makedirs(output_dir, exist_ok=True)
    with open(os.path.join(output_dir, f"{split}_results.json"), "w") as f:
        json.dump(metrics, f, indent=2, sort_keys=True)
    all_path = os.path.join(output_dir, "all_results.json")
    allm = {}
    if os.path.exists(all_path):
        with open(all_path) as f:
            allm = json.load(f)
    allm.update(metrics)
    with open(all_path, "w") as f:
        json.dump(allm, f, indent=2, sort_keys=True)


class Trainer:
    """The epoch loop of `rgbdseg_tpu/train/trainer.py::Trainer` on the port's
    step: `Trainer(cfg, args, train_dataset, eval_dataset, id2label,
    state_dict=None, device=None)`. The model gets the port's seeded weights
    (seed `args.seed`), then `state_dict`'s tensors of matching shape (`graft`;
    the skipped ones are logged), on the CUDA device unless `device` names
    another (raises without CUDA); in several processes on `cuda:LOCAL_RANK`,
    distributed over `make_mesh(args.num_devices, args.model_parallel_size)`
    (`distribute`). `self.model` is the (sharded) model, `self.net` the one
    that steps (DDP-wrapped when the data width is above 1)."""

    def __init__(self, cfg: ModelConfig, args: TrainingArguments, train_dataset=None, eval_dataset=None,
                 id2label: Optional[dict] = None, state_dict: Optional[dict] = None, device=None):
        self.cfg, self.args = cfg, args
        self.train_dataset, self.eval_dataset = train_dataset, eval_dataset
        self.id2label = id2label or {}
        self.mesh = make_mesh(args.num_devices, args.model_parallel_size, device)
        self.device = self.mesh.device
        set_matmul_precision(args.matmul_precision)
        model = init_weights(Mask2FormerRGBD(cfg), args.seed)
        if state_dict is not None:
            skipped = graft(model, state_dict)
            for s in skipped:
                logger.warning("pretrained weight skipped: %s", s)
            logger.info("loaded pretrained weights (%d tensors skipped)", len(skipped))
        self.model = model.to(self.device).train()
        self.net, blocks = distribute(self.model, self.mesh)
        if blocks:
            logger.info("%d blocks sharded over the model group: %s", len(blocks), ", ".join(blocks))
        n = len(train_dataset) if train_dataset is not None else 1
        self.optimizer = make_optimizer(self.model, args, n, self.mesh.data_width)
        self.total_steps = self.optimizer.total_steps
        self.generator = torch.Generator(device=self.device).manual_seed(args.seed)
        self.log_history: list[dict] = []
        self.global_step = 0
        self.total_flos = 0.0
        self._flos_per_micro_step: dict[tuple, float] = {}  # (target bucket, mask dtype) -> flops

    @property
    def _global_train_batch(self) -> int:
        """HF semantics: per_device_train_batch_size x the data width."""
        return self.args.per_device_train_batch_size * self.mesh.data_width

    @property
    def _global_eval_batch(self) -> int:
        return self.args.per_device_eval_batch_size * self.mesh.data_width

    def _micro_per_epoch(self) -> int:
        n = len(self.train_dataset) if self.train_dataset is not None else 1
        return max(1, math.ceil(n / self._global_train_batch))

    def _steps_per_epoch(self) -> int:
        """Optimizer steps per epoch (micro-batches / gradient_accumulation_steps)."""
        return max(1, math.ceil(self._micro_per_epoch() / max(1, self.args.gradient_accumulation_steps)))

    def _preprocess(self, dataset) -> Optional[PreprocessConfig]:
        return getattr(dataset, "preprocess", None)

    def _micro_step(self, batch: TrainBatch, preprocess, sync: bool = True):
        """One micro-step; the first of each target bucket also counted for
        `total_flos` (FlopCounterMode plus the kernels' own formulas)."""
        key = (int(batch.mask_labels.shape[1]), str(batch.mask_labels.dtype))
        if key in self._flos_per_micro_step:
            loss, _ = micro_step(self.net, self.optimizer, batch, self.generator, preprocess, sync)
        else:
            from torch.utils.flop_counter import FlopCounterMode

            k0 = sum(kernels.FLOPS.values())
            with FlopCounterMode(display=False) as counter:
                loss, _ = micro_step(self.net, self.optimizer, batch, self.generator, preprocess, sync)
            self._flos_per_micro_step[key] = float(counter.get_total_flops() + sum(kernels.FLOPS.values()) - k0)
        self.total_flos += self._flos_per_micro_step[key]
        return loss

    def _restore(self, path: str) -> None:
        """Load a checkpoint into this trainer's model, optimizer and generator,
        on every rank (a sharded model takes its slices of the full tensors)."""
        self.global_step = load_checkpoint(path, self.model, self.optimizer, self.generator,
                                           shard=lambda name, t: local_shard(name, t, self.model))
        ts_path = os.path.join(self.args.output_dir, "trainer_state.json")
        if os.path.exists(ts_path):
            with open(ts_path) as f:
                self.total_flos = float(json.load(f).get("total_flos", 0.0))

    def train(self, resume_from_checkpoint: Optional[str] = None) -> dict:
        args = self.args
        os.makedirs(args.output_dir, exist_ok=True)
        pp = self._preprocess(self.train_dataset)
        single = self.mesh.world_size == 1
        # compaction and packed targets are single-process only, as in the JAX package
        put_args = args if single else dataclasses.replace(args, compact_instances=False, pack_targets=False)
        local_rows = None if single else host_row_range(self._global_train_batch, self.mesh)
        if put_args.pack_targets and hasattr(self.train_dataset, "pack_gt"):
            # batches carry bit-packed GT twins; put_batch ships those and the step unpacks them
            self.train_dataset.pack_gt = True
        if resume_from_checkpoint:
            self._restore(resume_from_checkpoint)
            logger.info("resumed from %s at step %d", resume_from_checkpoint, self.global_step)
        ga = max(1, args.gradient_accumulation_steps)
        b = self._global_train_batch
        micro_per_epoch = self._micro_per_epoch()
        steps_per_epoch = self._steps_per_epoch()
        start_epoch = self.global_step // steps_per_epoch
        num_epochs = int(args.num_train_epochs)
        logger.info("***** Running training ***** epochs=%s steps/epoch=%s device=%s mesh=%s", num_epochs,
                    steps_per_epoch, self.device, self.mesh.shape)
        t0 = time.time()
        total_loss, loss_count = 0.0, 0
        first_step_logged = False
        prof = None
        self.optimizer.zero_grad(set_to_none=True)
        for epoch in range(start_epoch, num_epochs):
            epoch_losses, epoch_gnorm = [], []
            micro_in_step = 0
            for mi, batch in enumerate(self.train_dataset.batches(b, shuffle=True, seed=args.seed, epoch=epoch,
                                                                  num_workers=args.dataloader_num_workers,
                                                                  local_rows=local_rows)):
                tb = put_batch(batch, put_args, self.device)
                if prof is None and args.profile_start_step is not None and self.global_step == args.profile_start_step:
                    prof = _start_profiler(self.device)
                # the gradients cross the data group at an optimizer step's last micro-batch
                loss = self._micro_step(tb, pp, sync=micro_in_step + 1 == ga or mi + 1 == micro_per_epoch)
                micro_in_step += 1
                if micro_in_step == ga:
                    epoch_gnorm.append(apply_step(self.optimizer, micro_in_step))
                    micro_in_step = 0
                    self.global_step += 1
                if prof is not None and self.global_step == args.profile_stop_step:
                    _stop_profiler(prof, self.device, args.output_dir)
                    prof = None
                epoch_losses.append(loss)
                if not first_step_logged:
                    first_step_logged = True
                    logger.info("first train step done in %.1fs, loss=%.4f", time.time() - t0, float(loss))
            if micro_in_step:
                # epoch-end remainder: step on the exact mean of what was accumulated
                epoch_gnorm.append(apply_step(self.optimizer, micro_in_step))
                micro_in_step = 0
                self.global_step += 1

            losses = torch.stack(epoch_losses).cpu()
            logger.info("epoch %d micro-step losses: %s", epoch + 1, json.dumps(losses.tolist()))
            total_loss += sum(losses.tolist())
            loss_count += len(epoch_losses)
            entry = {
                "loss": round(float(losses.mean()), 4),
                "grad_norm": float(torch.stack(epoch_gnorm).mean()),
                "learning_rate": float(self.optimizer.schedule(self.global_step)),
                "epoch": float(epoch + 1),
                "step": self.global_step,
            }
            self.log_history.append(entry)
            logger.info("epoch %d: %s", epoch + 1, entry)
            if args.do_eval and args.eval_strategy == "epoch" and self.eval_dataset is not None:
                metrics = self.evaluate()
                metrics["epoch"] = float(epoch + 1)
                metrics["step"] = self.global_step
                self.log_history.append(metrics)
            if args.save_strategy == "epoch":
                self._save(args.output_dir)
        if prof is not None:
            _stop_profiler(prof, self.device, args.output_dir)

        runtime = time.time() - t0
        n_samples = len(self.train_dataset) * max(num_epochs - start_epoch, 0)
        metrics = {
            "train_runtime": round(runtime, 4),
            "train_samples_per_second": round(n_samples / max(runtime, 1e-9), 3),
            "train_steps_per_second": round((self.global_step - start_epoch * steps_per_epoch) / max(runtime, 1e-9), 3),
            "train_loss": total_loss / max(loss_count, 1),
            "epoch": float(num_epochs),
            "total_flos": self.total_flos,
        }
        self.save_state()
        return metrics

    def full_state_dict(self) -> dict:
        """The model's state_dict, a sharded model's gathered to full tensors
        (every rank must call it)."""
        return full_state_dict(self.model)

    def _save(self, output_dir: str) -> Optional[str]:
        """A checkpoint of the full tensors, written by rank 0; every rank waits for it."""
        shards = self.model.tp_shards
        opt = self.optimizer.state_dict()
        opt["state"] = {n: {k: _gather(v, shards.get(n), self.model) for k, v in st.items()}
                        for n, st in opt["state"].items()}
        model_state = self.full_state_dict()
        path = None
        if is_main_process():
            path = write_checkpoint(output_dir, self.global_step, model_state, opt, self.generator.get_state(),
                                    self.args.save_total_limit)
        barrier()
        return path

    def save_state(self) -> None:
        """trainer_state.json, written by rank 0."""
        if not is_main_process():
            return
        path = os.path.join(self.args.output_dir, "trainer_state.json")
        os.makedirs(self.args.output_dir, exist_ok=True)
        with open(path, "w") as f:
            json.dump({"global_step": self.global_step, "log_history": self.log_history, "best_metric": None,
                       "total_flos": self.total_flos}, f, indent=2)

    def _eval_generator(self) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(self.args.seed)

    def _eval_batches(self, dataset):
        """The dataset's batches at per_device_eval_batch_size, their GT
        bit-packed by the pipeline and, under `compact_instances`, compacted as
        the train step's (the JAX Trainer's eval goes through the same `_put`)."""
        if hasattr(dataset, "pack_gt"):
            dataset.pack_gt = True
        for batch in dataset.batches(self._global_eval_batch, num_workers=self.args.dataloader_num_workers):
            if self.args.compact_instances and self.mesh.world_size == 1:
                packed = batch.mask_labels_packed
                out = compact_targets(batch.mask_labels, batch.class_labels, batch.valid,
                                      self.args.instance_bucket_floor, packed=packed)
                batch = dataclasses.replace(batch, mask_labels=out[0], class_labels=out[1], valid=out[2],
                                            mask_labels_packed=out[3] if packed is not None else None)
            yield batch

    def evaluate(self, dataset=None, prefix: str = "eval_") -> dict:
        """`evaluate` over `dataset` (default: the eval dataset), the padded rows
        of the last batch cut, the loss points from a generator seeded with
        `args.seed`."""
        dataset = dataset or self.eval_dataset
        return evaluate(self.model, self._eval_batches(dataset), self.id2label, self._preprocess(dataset),
                        prefix=prefix, generator=self._eval_generator(), bf16=self.args.bf16,
                        num_examples=len(dataset))

    def predict(self, dataset, prefix: str = "test_") -> tuple[list, dict]:
        """(host logits of each batch cut to its real rows, metrics over them)."""
        batches = list(self._eval_batches(dataset))
        return predict(self.model, batches, self.id2label, self._preprocess(dataset), prefix=prefix,
                       num_examples=len(dataset), bf16=self.args.bf16, generator=self._eval_generator())


def _gather(t: torch.Tensor, dim: Optional[int], model) -> torch.Tensor:
    """A tensor of a sharded parameter's shape gathered to the full one (on the
    CPU moments too: `sharding.gather_shard` on the model's device)."""
    if dim is None:
        return t
    dev = next(model.parameters()).device
    return gather_shard(t.to(dev), dim, model.mesh).cpu()


def _start_profiler(device: torch.device):
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    return prof


def _stop_profiler(prof, device: torch.device, output_dir: str) -> None:
    """Stop the profiler and write its trace to output_dir/profile/trace.json."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    prof.stop()
    out = os.path.join(output_dir, "profile")
    os.makedirs(out, exist_ok=True)
    rank = "" if is_main_process() else f"_rank{torch.distributed.get_rank()}"
    prof.export_chrome_trace(os.path.join(out, f"trace{rank}.json"))
    logger.info("profiler trace written to %s", out)
