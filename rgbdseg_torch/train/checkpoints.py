"""Training checkpoints with the reference's resume semantics (counterpart of
`rgbdseg_tpu/train/checkpoints.py`, with `torch.save` in place of orbax).

`find_last_checkpoint` mirrors the reference (model_essential_part.py:160-179):
resume from the newest `checkpoint-*` in output_dir; refuse to train into a
non-empty output_dir that holds no checkpoint unless overwrite is allowed.

A checkpoint is a directory `checkpoint-{step}/` of two files:
- `model.pt`: the model's `state_dict` (parameters, BatchNorm running
  statistics and `num_batches_tracked`), on the CPU;
- `trainer.pt`: the optimizer's `state_dict` (`optim.AdamW`: its step count
  and the moments by parameter name), `step`, and `rng`, the `get_state()` of
  the generator that draws dropout, drop path and the criterion's points (the
  JAX checkpoint's carried PRNG key).
Both are read with `torch.load(..., weights_only=True)`. `load_checkpoint_partial`
reads the model alone, for inference.

The JAX package's `migrate_checkpoint` rewrites orbax checkpoints of a layout
the port never wrote; weights cross between the packages through the HF export
(`utils/hf_convert.py`).
"""

from __future__ import annotations

import os
import re
import shutil
from typing import Callable, Optional

import torch

_CKPT_RE = re.compile(r"^checkpoint-(\d+)$")
MODEL_FILE, TRAINER_FILE = "model.pt", "trainer.pt"


def find_last_checkpoint(output_dir: str, overwrite: bool = False) -> Optional[str]:
    if not os.path.isdir(output_dir):
        return None
    entries = [e for e in os.listdir(output_dir) if _CKPT_RE.match(e)]
    if not entries:
        visible = [e for e in os.listdir(output_dir) if not e.startswith(".")]
        if visible and not overwrite:
            raise ValueError(
                f"Output directory ({output_dir}) exists, is not empty and has no "
                "checkpoint; set overwrite_output_dir to train from scratch."
            )
        return None
    last = max(entries, key=lambda e: int(_CKPT_RE.match(e).group(1)))
    return os.path.join(output_dir, last)


def save_checkpoint(output_dir: str, step: int, model: torch.nn.Module, optimizer, generator: torch.Generator,
                    save_total_limit: Optional[int] = None) -> str:
    """Write `checkpoint-{step}/` under output_dir and keep only the newest
    `save_total_limit` checkpoints; returns the checkpoint's path."""
    return write_checkpoint(output_dir, step, model.state_dict(), optimizer.state_dict(), generator.get_state(),
                            save_total_limit)


def write_checkpoint(output_dir: str, step: int, model_state: dict, optimizer_state: dict, rng_state: torch.Tensor,
                     save_total_limit: Optional[int] = None) -> str:
    """`save_checkpoint` of the states themselves (a tensor-parallel model's
    gathered to full tensors first)."""
    path = os.path.abspath(os.path.join(output_dir, f"checkpoint-{step}"))
    tmp = path + ".tmp"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    torch.save({k: v.detach().cpu() for k, v in model_state.items()}, os.path.join(tmp, MODEL_FILE))
    torch.save({"optimizer": optimizer_state, "step": int(step), "rng": rng_state},
               os.path.join(tmp, TRAINER_FILE))
    shutil.rmtree(path, ignore_errors=True)
    os.replace(tmp, path)
    if save_total_limit:
        entries = sorted(
            (e for e in os.listdir(output_dir) if _CKPT_RE.match(e)),
            key=lambda e: int(_CKPT_RE.match(e).group(1)),
        )
        for e in entries[:-save_total_limit]:
            shutil.rmtree(os.path.join(output_dir, e), ignore_errors=True)
    return path


def load_checkpoint(path: str, model: torch.nn.Module, optimizer, generator: torch.Generator,
                    shard: Optional[Callable[[str, torch.Tensor], torch.Tensor]] = None) -> int:
    """Restore a checkpoint into `model`, `optimizer` and `generator` (each on
    its own device, the generator's state included); returns its step.
    `shard(name, full tensor)` cuts each parameter and moment to a
    tensor-parallel model's slice."""
    cut = shard or (lambda name, t: t)
    model.load_state_dict({k: cut(k, v) for k, v in load_checkpoint_partial(path).items()}, strict=True)
    state = torch.load(os.path.join(path, TRAINER_FILE), map_location="cpu", weights_only=True)
    opt = state["optimizer"]
    optimizer.load_state_dict({"count": opt["count"],
                               "state": {n: {k: cut(n, v) for k, v in st.items()} for n, st in opt["state"].items()}})
    generator.set_state(state["rng"])
    return int(state["step"])


def load_checkpoint_partial(path: str) -> dict[str, torch.Tensor]:
    """The model's `state_dict` of a training checkpoint, on the CPU, without
    the optimizer's moments or the generator."""
    return torch.load(os.path.join(path, MODEL_FILE), map_location="cpu", weights_only=True)
