"""Argument schema and config parsing (a copy of `rgbdseg_tpu/train/arguments.py`:
`Arguments`, `TrainingArguments`, `parse_args`, same names and defaults).

`prog config.json` or `prog --flag value ...`: a data/model `Arguments` block
and a `TrainingArguments` block, from one JSON file or command-line flags.

`num_devices` and `model_parallel_size` lay the processes out
(`parallel.make_mesh`): the port runs one process per device, so
`num_devices` is the process group's world size (None: whatever it is).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from typing import Optional


@dataclasses.dataclass
class Arguments:
    # data
    root_path: str = "."
    train_json_path: str = "train.json"
    valid_json_path: str = "valid.json"
    label2id_path: str = "label2id.json"
    image_height: int = 256
    image_width: int = 256
    do_reduce_labels: bool = False
    ignore_index: Optional[int] = None
    max_instances: int = 20
    # ship packed raw uint8 frames and build the float channel stack on the
    # device inside the train and eval steps (data/device_preprocess.py)
    device_channels: bool = True
    # model
    model_name_or_path: Optional[str] = None  # optional checkpoint to load
    version: str = "0.0.0"
    # optional ModelConfig JSON overriding the default full-size architecture
    model_config_json: Optional[str] = None
    # export
    prediction_json_path: Optional[str] = None
    gt_json_path: Optional[str] = None
    comparison_output_dir: Optional[str] = None


@dataclasses.dataclass
class TrainingArguments:
    output_dir: str = "output"
    num_train_epochs: float = 1.0
    per_device_train_batch_size: int = 1
    per_device_eval_batch_size: int = 1
    learning_rate: float = 1e-5
    weight_decay: float = 0.0
    adam_beta1: float = 0.9
    adam_beta2: float = 0.999
    adam_epsilon: float = 1e-8
    max_grad_norm: float = 1.0  # HF Trainer default clip
    warmup_ratio: float = 0.0
    seed: int = 42
    logging_strategy: str = "epoch"
    eval_strategy: str = "epoch"
    save_strategy: str = "epoch"
    save_total_limit: Optional[int] = 2
    do_train: bool = True
    do_eval: bool = True
    # f32 master parameters and optimizer state, a bf16 forward, f32 losses
    bf16: bool = False
    matmul_precision: str = "float32"  # float32 | bfloat16_3x | bfloat16
    # optimizer steps happen every N micro-batches; gradients are the exact
    # mean over the micro-batches accumulated
    gradient_accumulation_steps: int = 1
    # slice each batch's padded instance targets to the smallest power-of-two
    # bucket (>= instance_bucket_floor) covering its real instances
    # (data/pipeline.compact_targets)
    compact_instances: bool = True
    instance_bucket_floor: int = 8
    # ship the GT masks bit-packed and unpack them on the device
    pack_targets: bool = True
    dataloader_num_workers: int = 4
    resume_from_checkpoint: Optional[str] = None
    overwrite_output_dir: bool = False
    num_devices: Optional[int] = None  # total devices (default: all)
    model_parallel_size: int = 1  # tensor-parallel width; 1 = data parallelism only
    # profiler trace of training steps [profile_start_step, profile_stop_step), written to
    # output_dir/profile/trace.json; it carries the port's `rgbdseg.*` spans (utils/trace.py)
    profile_start_step: Optional[int] = None
    profile_stop_step: Optional[int] = None
    # upload output_dir to the HF Hub after training
    push_to_hub: bool = False
    hub_model_id: Optional[str] = None  # default: basename(output_dir)


def _add_fields(parser: argparse.ArgumentParser, dc) -> None:
    for f in dataclasses.fields(dc):
        name = "--" + f.name
        if f.type in ("bool", bool):
            parser.add_argument(name, type=lambda s: s.lower() in ("1", "true", "yes"), default=f.default)
        else:
            t = {int: int, float: float, str: str}.get(f.type, None)
            if t is None:
                t = str if "str" in str(f.type) else (float if "float" in str(f.type) else (int if "int" in str(f.type) else str))
            parser.add_argument(name, type=t, default=f.default)


def parse_args(argv: Optional[list[str]] = None) -> tuple[Arguments, TrainingArguments]:
    """`prog config.json` or `prog --flag value ...`."""
    import sys

    argv = list(sys.argv[1:] if argv is None else argv)
    if len(argv) == 1 and argv[0].endswith(".json"):
        with open(argv[0]) as f:
            raw = json.load(f)
        a_kwargs = {f.name: raw[f.name] for f in dataclasses.fields(Arguments) if f.name in raw}
        t_kwargs = {f.name: raw[f.name] for f in dataclasses.fields(TrainingArguments) if f.name in raw}
        return Arguments(**a_kwargs), TrainingArguments(**t_kwargs)

    parser = argparse.ArgumentParser()
    _add_fields(parser, Arguments)
    _add_fields(parser, TrainingArguments)
    ns = vars(parser.parse_args(argv))
    a = Arguments(**{f.name: ns[f.name] for f in dataclasses.fields(Arguments)})
    t = TrainingArguments(**{f.name: ns[f.name] for f in dataclasses.fields(TrainingArguments)})
    return a, t
