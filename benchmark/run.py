"""Run one cell of the port's benchmark once and print its result line.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout, on a machine with the CUDA cards the cell asks
for (none: exit 2 and no result). With `--trace 0` the line carries the cell's
end-to-end metrics, with `--trace 1` its per-layer metrics, the device's busy
and window seconds and a breakdown. `kernel_build` says how many of the port's
kernel sources the run compiled (a checkout's first run: all; its nvcc time
counts in `setup_s`) and in how many seconds. The numbers that decide `correct` are
printed beside their limits, last on standard error and last in the line.
A run that finds JAX, flax, optax or the JAX package loaded exits 3 with no result.
"""

import time

T_TOP = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "rgbdseg_tpu"}


def process_start() -> float:
    """The process's start on the wall clock (Linux's /proc), else this module's first line."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rpartition(")")[2].split()[19])
        with open("/proc/stat") as f:
            btime = next(int(line.split()[1]) for line in f if line.startswith("btime"))
        return btime + start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, StopIteration, IndexError):
        return T_TOP


def forbidden_modules() -> list:
    """The loaded modules whose top-level name is JAX's, flax's, optax's or the JAX package's."""
    return sorted({name.split(".")[0] for name in sys.modules} & FORBIDDEN)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    t_start = min(process_start(), T_TOP)
    sys.path.insert(0, str(ROOT))
    import torch

    from benchmark import harness

    cell = harness.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{args.workload} needs {cell.chips} CUDA card(s); found {found}", file=sys.stderr)
        return 2
    run = harness.KINDS[cell.traffic["kind"]](cell, args.seed, args.seconds, bool(args.trace), "cuda:0", t_start)
    line = harness.result(run, bool(args.trace))
    found = forbidden_modules()
    if found:
        print(f"the run loaded {found}: the benchmark measures the port alone", file=sys.stderr)
        return 3
    print(f"kernel_build: {run.build} (inside setup_s; sources_built > 0 marks a checkout's first run)",
          file=sys.stderr)
    for key, value in run.extra.items():
        print(f"{key}: {value}", file=sys.stderr)
    for name, value in run.numbers.items():
        if name not in line["checks"]:
            print(f"reading {name}: {value!r} (not compared)", file=sys.stderr)
    for name, c in line["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
