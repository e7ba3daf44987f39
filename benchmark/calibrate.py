"""The readings that each cell's limits are set from, on the card, at the cell's size.

    python3 benchmark/calibrate.py --workload <name> --seeds 1,2,3 [--control tf32|bfloat16|float8_e4m3fn]
                                   [--fault half_batch|unchanged|altered] [--seconds 3]

Per seed, one JSON line of the numbers `check` compares:
- as a run reads them (the port against the reference; a short window, at
  the cell's own batch and sizes), or with `--fault`, with that fault planted
  in the port's timed path;
- with `--control`, the control: the reference itself computed in the lower
  precision (`tf32`: TF32 products in a float32 cell; a dtype: every product's
  operands rounded to it) in the port's place, against the reference (in an
  eval cell, forced by the control's masks as a run's is by the port's);
  `--control ulp` is the witness of rounding alone: every float32 operand's
  last mantissa bit cleared.
A train run's line also carries `look`: the leaves with the widest gaps and
the deciles of the first gradient's leaf gaps.
All seeds run in one process. The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def control_numbers(cell, seed: int, control, device) -> dict:
    """The control's numbers for one seed: the lowered reference against the reference."""
    import torch

    from benchmark import check, harness

    tr = cell.traffic
    _, rcfg = harness.model_configs(cell.config)
    state = harness._weights(rcfg, seed, device)
    ring = harness._ring(cell, seed, tr["ring"])
    if tr["kind"] == "train":
        from rgbdseg_torch.train.trainer import make_optimizer  # the schedule's step count, as the port's

        total = _total_steps(cell, make_optimizer)
        low = check.reference_train(rcfg, state, ring, seed, device, tr, total, control=control)
        ref = check.reference_train(rcfg, state, ring, seed, device, tr, total)
        return check.train_numbers(low, ref)
    id2label = {i: f"class{i}" for i in range(cell.config["num_labels"])}
    n = len(ring)
    low = check.reference_eval(rcfg, state, ring, n, seed, device, id2label, control=control, keep_layers=True)
    ref = check.reference_eval(rcfg, state, ring, n, seed, device, id2label, forced=dict(enumerate(low["layers"])))
    prog = {"logits": dict(enumerate(low["logits"])), "stats": low["stats"], "loss": low["loss"], "map": low["map"]}
    del state
    torch.cuda.empty_cache()
    return check.eval_numbers(prog, ref, n)


def _total_steps(cell, make_optimizer) -> int:
    import torch

    from rgbdseg_torch.train.arguments import TrainingArguments

    tr = cell.traffic
    args = TrainingArguments(per_device_train_batch_size=tr["batch"], num_train_epochs=tr["epochs"])
    return make_optimizer(torch.nn.Linear(1, 1), args, tr["epoch_examples"]).total_steps


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", default=None)
    ap.add_argument("--fault", default=None)
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from benchmark import harness

    cell = harness.load_cell(args.workload)
    control = args.control
    if control not in (None, "tf32", "ulp"):
        control = getattr(torch, control)
    for seed in (int(s) for s in args.seeds.split(",")):
        t, look = time.time(), None
        if control is not None:
            numbers = control_numbers(cell, seed, control, "cuda:0")
        else:
            faults = (args.fault,) if args.fault else ()
            run = harness.KINDS[cell.traffic["kind"]](cell, seed, args.seconds, False, "cuda:0", time.time(), faults)
            numbers = run.numbers
            look = run.extra.get("worst_leaves")
        torch.cuda.empty_cache()
        print(json.dumps({"workload": args.workload, "seed": seed, "control": args.control, "fault": args.fault,
                          "numbers": numbers, "look": look, "s": round(time.time() - t, 1)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
