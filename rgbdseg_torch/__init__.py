"""PyTorch/CUDA port of the RGB-D Mask2Former (`rgbdseg_tpu` is the JAX reference).

Layout mirrors the JAX package: `config`, `versions`, `ops/` (resize, depth
decomposition, and the hand-written CUDA kernels under `ops/kernels` built from
`csrc/`), `models/`, `inference/`, `utils/`. The port imports nothing of the
JAX package; tests hold each module against its JAX counterpart.
"""
