"""PyTorch/CUDA port of the RGB-D Mask2Former (`rgbdseg_tpu` is the JAX reference).

Layout mirrors the JAX package: `config`, `versions`, `data/` (the channel
builders from raw uint8 frames, a PNG reader and writer, the dataset and its
batching, target compaction, the synthetic fixture generator),
`ops/` (resizes, Sobel, depth decomposition, losses, and the hand-written CUDA
kernels under `ops/kernels` built from `csrc/`), `models/`, `inference/`
(predictor, post-processing, COCO-RLE export, overlays), `native/` (the C RLE
codec), `train/` (arguments, train step with accumulation and the bf16
policy, the epoch loop with checkpoints and resume, evaluate, predict,
evaluator, mAP, model card, hub upload), `utils/` (weights, the HF checkpoint
bridge, a safetensors reader and writer), `parallel/` (data and tensor
parallelism over torch.distributed), `tools/` (the learning proof, the QA
viewers). The port imports nothing of the JAX package; tests hold each module
against its JAX counterpart.
"""
