"""device_idle.train.bf16: the share of the traced stretch in which the card ran nothing."""

from benchmark import readers


def read(run):
    return readers.idle(run)
