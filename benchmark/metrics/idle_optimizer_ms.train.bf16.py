"""idle_optimizer_ms.train.bf16: ms per step in which the card waits on the optimizer step (clip and AdamW): the
idle time under the program's `apply_step` span."""

from benchmark import program


def read(run):
    return program.idle_ms(run, "apply_step")
