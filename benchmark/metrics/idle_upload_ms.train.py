"""idle_upload_ms.train: ms per step in which the card waits on the host-to-device copies of a batch: the
idle time under the program's `upload` span."""

from benchmark import program


def read(run):
    return program.idle_ms(run, "upload")
