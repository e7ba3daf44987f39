"""kernel_roofline.eval: the hand kernels' share of their roofline in an eval batch (K1, K3, PS)."""

from benchmark import readers


def read(run):
    return readers.roofline(run, ("k1", "k3", "ps"))
