"""mfu.train.bf16: the traced stretch's share of the card's dense peak, by the reference's FLOPs."""

from benchmark import readers


def read(run):
    return readers.mfu(run)
