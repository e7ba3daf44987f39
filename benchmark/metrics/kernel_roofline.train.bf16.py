"""kernel_roofline.train.bf16: the hand kernels' share of their roofline in a train step (K1, K1-bwd, K3, K3-bwd, PS, PS-bwd)."""

from benchmark import readers


def read(run):
    return readers.roofline(run, ("k1", "k1_bwd", "k3", "k3_bwd", "ps", "ps_bwd"))
