"""idle_gc_ms.train: ms per step in which the card waits on Python's cyclic garbage collector: the
idle time under the program's `host.gc` span."""

from benchmark import program


def read(run):
    return program.idle_ms(run, "host.gc")
