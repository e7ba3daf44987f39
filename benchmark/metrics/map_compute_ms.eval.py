"""map_compute_ms.eval: host ms per image of the mAP's `Evaluator.compute`,
over the run's `evaluate` calls (the program's `map.compute_s` and `map.images`)."""

from benchmark import program


def read(run):
    return program.map_compute_ms(run)
