"""idle_cast_ms.train.bf16: ms per step in which the card waits on the bf16 policy's copies of the parameters and pixels: the
idle time under the program's `forward.cast` span."""

from benchmark import program


def read(run):
    return program.idle_ms(run, "forward.cast")
