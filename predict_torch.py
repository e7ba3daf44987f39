#!/usr/bin/env python
"""Inference CLI of the PyTorch port (the counterpart of `predict.py`;
reference `predictor.py`).

Single image (RGB-D versions take the depth frame too; 0.3.0 its on-disk
gradient image as a third frame, 0.2.0 eight augmentation frames, each given
by one `--extra_frame`):
    python predict_torch.py --checkpoint out/checkpoint-N --version 0.4.0 --num_labels 3 \
        --image img.png --depth depth.png --save overlay.png [--device cpu]
    python predict_torch.py --version 0.3.0 --image img.png --depth depth.png --extra_frame grad.png
    python predict_torch.py --hf_checkpoint out --image img.png --depth depth.png --save overlay.png
Multi-model comparison from exported JSONs:
    python predict_torch.py --compare --gt_json gt.json --model_json name=pred.json --output_dir viz/

`--checkpoint` takes a training checkpoint of `finetune_torch.py` (its model
weights alone); `--hf_checkpoint` an HF checkpoint directory, such as the one
finetune_torch.py exports into output_dir (its `rgbdseg_version` tag and
config give the model). Without either the weights are the port's seeded
initialisation. It runs on the CUDA device unless `--device cpu` is given.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def main(argv=None, device=None):
    """Serve one image (returns the post-processed result) or draw the
    comparison grids (returns None)."""
    from rgbdseg_torch.inference.predictor import pop_device_flag

    argv, flag_device = pop_device_flag(list(sys.argv[1:] if argv is None else argv))
    ap = argparse.ArgumentParser()
    ap.add_argument("--checkpoint")
    ap.add_argument(
        "--hf_checkpoint",
        help="HF Mask2Former checkpoint dir (config.json + model.safetensors) — "
        "loads reference-trained weights directly",
    )
    ap.add_argument("--version", default="0.0.0")
    ap.add_argument("--num_labels", type=int, default=2)
    ap.add_argument("--image")
    ap.add_argument("--depth")
    ap.add_argument("--extra_frame", action="append", default=[],
                    help="frames after the depth, in the order of a meta-JSON record's \"image\" list")
    ap.add_argument("--save")
    ap.add_argument("--threshold", type=float, default=0.5)
    ap.add_argument("--image_height", type=int, default=256)
    ap.add_argument("--image_width", type=int, default=256)
    ap.add_argument("--compare", action="store_true")
    ap.add_argument("--gt_json")
    ap.add_argument("--model_json", action="append", default=[])
    ap.add_argument("--output_dir", default="viz")
    ap.add_argument(
        "--model_config_json",
        help="ModelConfig JSON overriding the default full-size architecture "
        "(num_labels/version still come from their flags)",
    )
    args = ap.parse_args(argv)

    if args.compare:
        from rgbdseg_torch.inference.visualize import visualize_multi_model_json_results

        models = dict(kv.split("=", 1) for kv in args.model_json)
        visualize_multi_model_json_results(args.gt_json, models, args.output_dir)
        print(f"comparison grids written to {args.output_dir}")
        return None

    from rgbdseg_torch.config import ModelConfig, PreprocessConfig
    from rgbdseg_torch.data.image_io import load_rgb
    from rgbdseg_torch.inference.predictor import Predictor
    from rgbdseg_torch.train.checkpoints import load_checkpoint_partial
    from rgbdseg_torch.utils.hf_convert import graft, load_hf_checkpoint

    cfg = ModelConfig(num_labels=args.num_labels, version=args.version)
    if args.model_config_json:
        with open(args.model_config_json) as f:
            cfg = ModelConfig.from_json(f.read()).replace(num_labels=args.num_labels, version=args.version)
    pp = PreprocessConfig(height=args.image_height, width=args.image_width)

    hf_state = None
    if args.hf_checkpoint:
        # an export of finetune_torch.py carries its fusion weights, BatchNorm
        # statistics and version tag
        cfg, hf_state = load_hf_checkpoint(args.hf_checkpoint, version=args.version, with_batch_stats=True)
    predictor = Predictor(cfg, device=device or flag_device, preprocess=pp)
    if hf_state is not None:
        # onto the seeded weights: a version's fusion modules a stock trunk lacks keep them
        for s in graft(predictor.model, hf_state):
            print(f"skipped pretrained weight: {s}")
    if args.checkpoint:
        predictor.model.load_state_dict(load_checkpoint_partial(args.checkpoint), strict=True)

    if args.depth:
        res, _ = predictor.predict_and_overlay_files([args.image, args.depth, *args.extra_frame],
                                                     threshold=args.threshold, save=args.save)
    else:
        res, _ = predictor.predict_and_overlay(load_rgb(args.image), threshold=args.threshold, save=args.save)
    for seg in res["segments_info"]:
        print(seg)
    if args.save:
        print(f"overlay saved to {args.save}")
    return res


if __name__ == "__main__":
    main()
