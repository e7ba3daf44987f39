#!/usr/bin/env python
"""Training and evaluation CLI of the PyTorch port (the counterpart of
`finetune.py`; reference `finetuning.py`).

Usage:  python finetune_torch.py config.json [--device cpu]
        python finetune_torch.py --root_path ... --train_json_path ... [flags] [--device cpu]

The flow of finetune.py: parse the arguments (the JAX package's schema,
`rgbdseg_torch.train.arguments`) -> find the last checkpoint in output_dir ->
take the version from a pretrained checkpoint's `rgbdseg_version` tag ->
build the datasets and the ModelConfig (`model_config_json` overrides the
full-size default) -> graft a pretrained HF checkpoint from
`model_name_or_path` -> train (per-epoch eval and checkpoints, resume) ->
train metrics, trainer_state.json and the HF export into output_dir ->
predict on the valid set -> test metrics, the model card, the hub push ->
COCO-RLE JSON and comparison PNGs when their paths are set.

It runs on the CUDA device; `--device cpu` (stripped before the arguments are
parsed) or `main(argv, device="cpu")` runs it on the CPU.

Several processes, one per device (data parallelism over `num_devices`,
tensor parallelism over `model_parallel_size`):

    torchrun --nproc_per_node=N finetune_torch.py config.json [--device cpu]

`parallel.multihost.initialize()` joins the process group first (NCCL on the
card, each rank on `cuda:LOCAL_RANK`; Gloo with `--device cpu`). Every rank
trains and evaluates; rank 0 alone writes the artifacts.
"""

import json
import logging
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from rgbdseg_torch.config import ModelConfig
from rgbdseg_torch.data.pipeline import build_datasets
from rgbdseg_torch.inference.predictor import pop_device_flag
from rgbdseg_torch.models.mask2former import Mask2FormerRGBD
from rgbdseg_torch.parallel.mesh import barrier, is_main_process, mesh_device
from rgbdseg_torch.parallel.multihost import initialize
from rgbdseg_torch.train.arguments import parse_args
from rgbdseg_torch.train.checkpoints import find_last_checkpoint
from rgbdseg_torch.train.trainer import Trainer, save_metrics
from rgbdseg_torch.utils.log import setup_logging

logger = logging.getLogger(__name__)


def main(argv=None, device=None):
    """Run the flow; returns the Trainer."""
    argv, flag_device = pop_device_flag(list(sys.argv[1:] if argv is None else argv))
    initialize(device=device or flag_device)
    dev = mesh_device(device or flag_device)
    args, training_args = parse_args(argv)
    setup_logging()
    logger.info("Training/evaluation parameters %s", training_args)

    last_checkpoint = None
    if training_args.do_train and not training_args.overwrite_output_dir:
        last_checkpoint = find_last_checkpoint(training_args.output_dir, training_args.overwrite_output_dir)
        if last_checkpoint:
            logger.info("Resuming from checkpoint %s", last_checkpoint)

    # The version comes from a tagged HF export before the datasets are built:
    # the data pipeline's channel layout must match the model's.
    pretrained_dir = args.model_name_or_path if args.model_name_or_path and os.path.isfile(
        os.path.join(args.model_name_or_path, "config.json")) else None
    if pretrained_dir:
        with open(os.path.join(pretrained_dir, "config.json")) as f:
            tagged = json.load(f).get("rgbdseg_version")
        if tagged and tagged != args.version:
            logger.info("checkpoint carries version %s (overriding --version %s)", tagged, args.version)
            args.version = tagged

    train_ds, valid_ds, label2id, id2label = build_datasets(args)
    cfg = ModelConfig(num_labels=len(label2id), version=args.version)
    if args.model_config_json:
        with open(args.model_config_json) as f:
            cfg = ModelConfig.from_json(f.read()).replace(num_labels=len(label2id), version=args.version)

    # A pretrained HF Mask2Former directory gives the trunk (reference workflow:
    # finetune from facebook/mask2former-swin-tiny-coco-instance,
    # finetuning.py:86-92); a class head of another num_labels stays fresh.
    pretrained = None
    if pretrained_dir:
        from rgbdseg_torch.utils.hf_convert import load_hf_checkpoint

        hf_cfg, pretrained = load_hf_checkpoint(pretrained_dir, version=args.version, with_batch_stats=True)
        cfg = hf_cfg.replace(num_labels=len(label2id))
        logger.info("loaded pretrained HF checkpoint from %s (version %s)", pretrained_dir, cfg.version)

    trainer = Trainer(cfg, training_args, train_ds, valid_ds, id2label, state_dict=pretrained, device=dev)

    if training_args.do_train:
        metrics = trainer.train(resume_from_checkpoint=training_args.resume_from_checkpoint or last_checkpoint)
        metrics["train_samples"] = len(train_ds)
        save_metrics(training_args.output_dir, "train", metrics)
        trainer.save_state()
        # The reference's training artifact: an HF checkpoint directory at
        # output_dir (finetuning.py:114-117) in its key layout.
        from rgbdseg_torch.utils.hf_convert import export_hf_checkpoint

        model = trainer.model
        if trainer.model.tp_shards:  # the full tensors, in a model of the full shapes
            full = trainer.full_state_dict()
            model = Mask2FormerRGBD(cfg)
            model.load_state_dict({k: v.cpu() for k, v in full.items()})
        if is_main_process():
            export_hf_checkpoint(model, cfg, training_args.output_dir, id2label=id2label)
            logger.info("HF checkpoint exported to %s", training_args.output_dir)

    if training_args.do_eval:
        outputs, metrics = trainer.predict(valid_ds)
        metrics["test_samples"] = len(valid_ds)
        save_metrics(training_args.output_dir, "test", metrics)
        logger.info("test metrics: %s", json.dumps(metrics, indent=2))
    if training_args.do_eval and is_main_process():
        from rgbdseg_torch.train.model_card import create_model_card

        create_model_card(
            training_args.output_dir,
            model_name=os.path.basename(os.path.normpath(training_args.output_dir)),
            training_args=training_args,
            eval_metrics=metrics,
            log_history=trainer.log_history,
            base_model=args.model_name_or_path or None,
            dataset_name=args.train_json_path,
        )
        if training_args.push_to_hub:
            from rgbdseg_torch.train.hub import push_to_hub

            push_to_hub(training_args.output_dir, repo_id=training_args.hub_model_id)

        if args.prediction_json_path or args.gt_json_path or args.comparison_output_dir:
            from rgbdseg_torch.inference.export import process_prediction

            process_prediction(
                outputs,
                valid_ds,
                id2label,
                prediction_json_path=args.prediction_json_path,
                gt_json_path=args.gt_json_path,
                comparison_output_dir=args.comparison_output_dir,
            )
    barrier()
    return trainer


if __name__ == "__main__":
    main()
