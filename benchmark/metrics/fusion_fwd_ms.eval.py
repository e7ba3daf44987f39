"""fusion_fwd_ms.eval: device ms per batch of the work launched inside the
program's `model.fusion` span (ratio predictor, DSAM / E-DSAM, DGGM), forward
only: the backward's kernels are launched on the autograd thread, outside it."""

from benchmark import program


def read(run):
    return program.device_ms(run, "model.fusion")
