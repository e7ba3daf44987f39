"""PyTorch/CUDA port of the RGB-D Mask2Former (`rgbdseg_tpu` is the JAX reference).

Layout mirrors the JAX package: `config`, `versions`, `data/` (the channel
builders from raw uint8 frames, a PNG reader), `ops/` (resizes, Sobel, depth
decomposition, losses, and the hand-written CUDA kernels under `ops/kernels`
built from `csrc/`), `models/`, `inference/`, `train/` (train step, evaluator,
mAP), `utils/`. The port imports nothing of the
JAX package; tests hold each module against its JAX counterpart.
"""
