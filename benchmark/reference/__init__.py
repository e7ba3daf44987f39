"""The benchmark's plain reference of the port's two benchmarked versions
(0.0.0 and 0.4.0): plain PyTorch in float32, no hand kernel, no cache, no
batching tricks. It imports nothing of `rgbdseg_torch` and nothing of the JAX
package; it is a frozen copy of the port's arithmetic as of the benchmark's
first commit, so that a later change to the port is judged against it.

- `model`: the channel builder, Swin-T, E-DSAM + DSAM + DGGM (0.4.0), the
  deformable pixel decoder, the masked-attention decoder;
- `criterion`: the Mask2Former loss with its Hungarian matching (scipy) and
  point sampling (`F.grid_sample`);
- `optim`: clip by global norm and AdamW, as the port's optax-style optimizer;
- `evaluation`: the per-image statistics of the mAP and the mAP itself
  (`map_metric`).
`lowp.lowered(dtype)` rounds every product's operands to a lower precision:
the control that the comparisons must fail.
"""
