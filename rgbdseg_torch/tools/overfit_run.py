"""Overfit the flagship model on the synthetic fixture and save the evidence
(a port of `rgbdseg_tpu/tools/overfit_run.py`, with its arguments).

Trains version 0.4.0 (full-size Swin-T + E-DSAM + DGGM by default) from
scratch on a tiny fixture with per-epoch eval, asserting that the eval mAP
ends >= --target, and writes trainer_state.json (the full log_history),
train_results.json, test_results.json, all_results.json, the training-curve
PNGs (`tools/plot_logs`) and a README.md that names the device, its power
limit and the command into --output.

Mirrors the reference's tiny-set methodology: train AND valid on the same tiny
split, metrics per epoch (experiments/architecture/architecture_change.md:67-96).

Usage (on the CUDA device; --device cpu with --tiny for a CPU rehearsal):
    python -m rgbdseg_torch.tools.overfit_run --output artifacts/overfit_torch \
        [--size 256] [--epochs 120] [--tiny] [--target 0.5] [--float32]
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time


def device_description(device) -> str:
    """The card's name and power limit as nvidia-smi prints them, or the device's name."""
    import torch

    if torch.device(device).type != "cuda":
        return f"CPU ({os.cpu_count()} cores)"
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.CalledProcessError):
        out = f"{torch.cuda.get_device_name(0)}, power limit not read"
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--output", default="artifacts/overfit_torch")
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--epochs", type=int, default=120)
    ap.add_argument("--num_images", type=int, default=8)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--target", type=float, default=0.5)
    ap.add_argument("--tiny", action="store_true", help="tiny ModelConfig (CPU-sized)")
    ap.add_argument("--float32", action="store_true", help="train in float32 instead of the JAX run's bf16")
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    from rgbdseg_torch.config import ModelConfig, PreprocessConfig
    from rgbdseg_torch.data import synthetic
    from rgbdseg_torch.data.pipeline import SegmentationDataset, load_meta
    from rgbdseg_torch.inference.predictor import resolve_device
    from rgbdseg_torch.train.arguments import TrainingArguments
    from rgbdseg_torch.train.trainer import Trainer, save_metrics
    from rgbdseg_torch.utils.log import setup_logging

    setup_logging()
    device = resolve_device(args.device)
    tmp = tempfile.mkdtemp(prefix="overfit_")
    fx = synthetic.generate(
        os.path.join(tmp, "set"),
        num_train=args.num_images,
        num_valid=0,
        size=(args.size, args.size),
        seed=5,
    )
    pp = PreprocessConfig(height=args.size, width=args.size)
    train_ds = SegmentationDataset(load_meta(fx["train"], fx["root"]), "0.4.0", pp, max_instances=6)

    cfg = (
        ModelConfig.tiny(num_labels=3, version="0.4.0")
        if args.tiny
        else ModelConfig(num_labels=3, version="0.4.0")
    )
    os.makedirs(args.output, exist_ok=True)
    targs = TrainingArguments(
        output_dir=args.output,
        num_train_epochs=args.epochs,
        per_device_train_batch_size=args.batch,
        per_device_eval_batch_size=args.batch,
        learning_rate=args.lr,
        warmup_ratio=0.05,
        seed=args.seed,
        eval_strategy="epoch",
        save_strategy="no",
        logging_strategy="epoch",
        dataloader_num_workers=2,
        bf16=not args.float32,
    )
    t0 = time.time()
    trainer = Trainer(cfg, targs, train_ds, train_ds, {0: "background", 1: "a", 2: "b"}, device=device)
    metrics = trainer.train()
    trainer.save_state()
    save_metrics(args.output, "train", metrics)
    final = trainer.evaluate()
    save_metrics(args.output, "test", {("test_" + k.removeprefix("eval_")): v for k, v in final.items()})
    wall = time.time() - t0

    maps = [e["eval_map"] for e in trainer.log_history if "eval_map" in e]
    print(json.dumps({"eval_map_trajectory": [round(m, 4) for m in maps]}))

    from rgbdseg_torch.tools.plot_logs import plot_multiple_training_metrics

    written = plot_multiple_training_metrics(
        {"overfit_v0.4.0": os.path.join(args.output, "trainer_state.json")},
        args.output,
    )
    print("curves:", written)

    command = (f"python -m rgbdseg_torch.tools.overfit_run --output {args.output} --size {args.size} "
               f"--epochs {args.epochs} --num_images {args.num_images} --batch {args.batch} --lr {args.lr}"
               f"{' --tiny' if args.tiny else ''}{' --float32' if args.float32 else ''}"
               f"{f' --device {args.device}' if args.device else ''}")
    with open(os.path.join(args.output, "README.md"), "w") as f:
        f.write(
            "# Overfit learning-proof artifact (PyTorch port)\n\n"
            f"`{command}`\n\n"
            f"Device: {device_description(device)}; torch {__import__('torch').__version__}.\n\n"
            f"Model: version 0.4.0 ({'tiny' if args.tiny else 'full-size'}), from scratch, "
            f"{'float32' if args.float32 else 'bf16 policy'}, synthetic fixture ({args.num_images} images, "
            f"{args.size}x{args.size}, seed 5), train and eval on the same images.\n\n"
            f"Final eval: mAP {final['eval_map']:.4f} (target >= {args.target}); train runtime "
            f"{metrics['train_runtime']:.1f} s, whole run {wall:.1f} s. The per-epoch trajectory is in "
            "trainer_state.json's log_history, curves in training_metrics.png.\n"
        )
    shutil.rmtree(tmp, ignore_errors=True)
    if final["eval_map"] < args.target:
        print(f"overfit failed: final eval_map {final['eval_map']:.4f} < {args.target} (trajectory {maps})")
        return 1
    print(f"OK: final eval_map {final['eval_map']:.4f} >= {args.target}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
