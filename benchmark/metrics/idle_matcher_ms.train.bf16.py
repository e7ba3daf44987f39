"""idle_matcher_ms.train.bf16: ms per step in which the card waits on the matcher (its device-to-host copy and host solve): the
idle time under the program's `matcher` span."""

from benchmark import program


def read(run):
    return program.idle_ms(run, "matcher")
