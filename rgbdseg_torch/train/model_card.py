"""Auto-generated model card, HF-Trainer format (a copy of
`rgbdseg_tpu/train/model_card.py`, with the port's package name and
framework versions).

Parity with the reference's end-of-training `trainer.create_model_card`
(reference: mask2former/finetuning.py:141-149); the output format mirrors the
model cards shipped with the reference checkpoints (e.g.
mask2former/checkpoints/remote/coco82v2_multi/README.md): YAML front matter,
final-eval bullet list, hyperparameter list, and a per-epoch training-results
table built from `trainer_state.json`-style log_history entries.
"""

from __future__ import annotations

import os


def _title(key: str) -> str:
    return key.replace("_", " ").title().replace("Map", "Map").replace("Mar", "Mar")


def _fmt(v) -> str:
    if isinstance(v, float):
        return f"{v:.4f}".rstrip("0").rstrip(".") if v == v else str(v)
    return str(v)


def create_model_card(
    output_dir: str,
    model_name: str,
    training_args,
    eval_metrics: dict | None = None,
    log_history: list[dict] | None = None,
    base_model: str | None = None,
    dataset_name: str | None = None,
) -> str:
    """Write README.md into output_dir; returns the path."""
    lines = [
        "---",
        "library_name: rgbdseg_torch",
    ]
    if base_model:
        lines.append(f"base_model: {base_model}")
    lines += [
        "tags:",
        "- image-segmentation",
        "- instance-segmentation",
        "- vision",
        "- rgb-d",
        "- generated_from_trainer",
        "model-index:",
        f"- name: '{model_name}'",
        "  results: []",
        "---",
        "",
        f"# {model_name}",
        "",
    ]
    desc = "This model was trained with the rgbdseg_torch framework"
    if base_model:
        desc = f"This model is a fine-tuned version of {base_model} (rgbdseg_torch)"
    if dataset_name:
        desc += f" on the {dataset_name} dataset"
    lines.append(desc + ".")

    eval_keys: list[str] = []
    if eval_metrics:
        lines += ["It achieves the following results on the evaluation set:"]
        for k in sorted(eval_metrics):
            if k.endswith(("runtime", "samples", "samples_per_second", "steps_per_second")):
                continue
            short = k.split("_", 1)[1] if "_" in k and k.split("_", 1)[0] in ("eval", "test") else k
            if short in ("epoch", "step"):
                continue
            eval_keys.append(short)
            lines.append(f"- {_title(short)}: {_fmt(eval_metrics[k])}")
    lines += [
        "",
        "## Training procedure",
        "",
        "### Training hyperparameters",
        "",
        "The following hyperparameters were used during training:",
        f"- learning_rate: {training_args.learning_rate}",
        f"- train_batch_size: {training_args.per_device_train_batch_size}",
        f"- eval_batch_size: {training_args.per_device_eval_batch_size}",
        f"- gradient_accumulation_steps: {getattr(training_args, 'gradient_accumulation_steps', 1)}",
        f"- seed: {training_args.seed}",
        f"- optimizer: AdamW (optax) with betas=({training_args.adam_beta1},{training_args.adam_beta2})"
        f" and epsilon={training_args.adam_epsilon}",
        "- lr_scheduler_type: linear",
        f"- num_epochs: {training_args.num_train_epochs}",
        f"- mixed_precision_training: {'bf16' if training_args.bf16 else 'off (float32)'}",
        f"- model_parallel_size: {getattr(training_args, 'model_parallel_size', 1)}",
    ]

    # Per-epoch results table from log_history (train entries carry 'loss',
    # eval entries carry 'eval_*'; pair them by step like HF does).
    history = log_history or []
    train_rows = {e["step"]: e for e in history if "loss" in e and "step" in e}
    eval_rows = [e for e in history if any(k.startswith("eval_") for k in e)]
    if eval_rows:
        metric_cols = [
            k.split("eval_", 1)[1]
            for k in eval_rows[0]
            if k.startswith("eval_")
            and not k.endswith(("runtime", "samples_per_second", "steps_per_second"))
        ]
        header = ["Training Loss", "Epoch", "Step", "Validation Loss"] + [
            _title(c) for c in metric_cols if c != "loss"
        ]
        lines += ["", "### Training results", "", "| " + " | ".join(header) + " |"]
        lines.append("|" + "|".join([":" + "-" * max(len(h), 3) + ":" for h in header]) + "|")
        for e in eval_rows:
            step = e.get("step", "")
            tr = train_rows.get(step, {})
            row = [
                _fmt(tr.get("loss", "")),
                _fmt(e.get("epoch", "")),
                str(step),
                _fmt(e.get("eval_loss", "")),
            ] + [_fmt(e.get(f"eval_{c}", "")) for c in metric_cols if c != "loss"]
            lines.append("| " + " | ".join(row) + " |")

    lines += ["", "### Framework versions", ""]
    try:
        import torch

        lines.append(f"- PyTorch {torch.__version__}")
    except Exception:
        pass
    lines.append("- rgbdseg_torch (RGB-D instance segmentation, PyTorch/CUDA)")

    path = os.path.join(output_dir, "README.md")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return path
