"""The readings that the limits of ``cells/<cell>.json`` are set from:
the program on many seeds and the cell's control on a few, at the cell's
own sizes and load, in one process (each run pays its own warm-up; the
kernels are built once).

    python3 perfbench/readings.py --workload <cell> --seeds 12 --controls 3
        --seconds 4 [--first-seed N] [--control JSON | --fault NAME]
        [--out <dir>]

prints one JSON line a run (``role`` "program" or "control", the seed,
``correct`` and each number compared beside its limit) and, last, the
largest reading of each number over the program's runs and the smallest
over the control's.  ``--fault`` runs one of the cell file's ``faults``
(a fault planted in the reference put in the program's place) in the
control's place.  The benchmark's own runs never run either.
"""

import argparse
import json
import math
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from perfbench.harness import ROOT, load_cell, run_cell  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--controls", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--first-seed", type=int, default=2_200_000_001)
    ap.add_argument("--out", default=None)
    ap.add_argument("--control", default=None,
                    help="a control as JSON in place of the cell file's")
    ap.add_argument("--fault", default=None,
                    help="one of the cell file's faults in the control's "
                         "place")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("readings: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    cell_file = load_cell(ROOT, args.workload)[4]
    if args.fault:
        control = cell_file["faults"][args.fault]
    elif args.control:
        control = json.loads(args.control)
    else:
        control = cell_file["control"]
    lower, upper = {}, {}
    lines = []
    plan = ([("program", None)] * args.seeds
            + [("control", control)] * args.controls)
    for i, (role, ctl) in enumerate(plan):
        seed = args.first_seed + 7919 * i
        out = run_cell(ROOT, args.workload, seed, args.seconds, False, device,
                       time.perf_counter(), control=ctl)
        row = {"role": role, "seed": seed, "correct": out["correct"],
               "attempted": out["attempted"], "failed": out["failed"],
               "checks": out["checks"]}
        lines.append(row)
        print(json.dumps(row), flush=True)
        for name, c in out["checks"].items():
            v = c["value"] if isinstance(c["value"], (int, float)) else math.inf
            if role == "program":
                lower[name] = max(lower.get(name, -math.inf), v)
            else:
                upper[name] = min(upper.get(name, math.inf), v)
    summary = {"workload": args.workload, "control": control,
               "lower": lower, "upper": upper}
    print(json.dumps(summary), flush=True)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, args.workload + ".jsonl"), "w") as fh:
            for row in lines + [summary]:
                fh.write(json.dumps(row) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
