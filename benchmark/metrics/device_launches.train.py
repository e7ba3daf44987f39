"""device_launches.train: kernels, copies and memsets per step or batch in the trace."""

from benchmark import readers


def read(run):
    return readers.launches(run)
