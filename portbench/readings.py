"""The readings a cell's limits are set from, in one process: the check's
numbers on sound sweeps of the program and on the control (the reference
in TF32 in the program's place), at the cell's own size.

    python3 portbench/readings.py --workload <cell> --seed <n>
        [--sound 12] [--control 3] [--fault <name> --faulty 3]
        [--out <file.jsonl>]

Each reading is one sweep, drawn from its own seed and checked as a run
checks it; the set-up fit is made once.  ``--fault`` reads as many sweeps
with a fault of :mod:`portbench.faults` planted in the program.  One JSON line a reading, on
standard output and appended to ``--out``.  The benchmark's own runs do
not run this.
"""

import argparse
import contextlib
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from portbench import faults, harness  # noqa: E402


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--sound", type=int, default=12)
    parser.add_argument("--control", type=int, default=3)
    parser.add_argument("--fault", choices=sorted(faults.FAULTS))
    parser.add_argument("--faulty", type=int, default=3)
    parser.add_argument("--out")
    args = parser.parse_args(argv)
    harness.set_environment()
    cell = harness.load_cell(args.workload)
    import torch

    device = "cuda" if torch.cuda.is_available() else "cpu"
    plan = [("float32", i) for i in range(args.sound)]
    plan += [("tf32", args.sound + i) for i in range(args.control)]
    if args.fault:
        first = args.sound + args.control
        plan += [(args.fault, first + i) for i in range(args.faulty)]
    for n, (kind, i) in enumerate(plan):
        seed = args.seed + i
        precision = "tf32" if kind == "tf32" else "float32"
        planted = (faults.FAULTS[kind]() if kind in faults.FAULTS
                   else contextlib.nullcontext())
        t0 = time.perf_counter()
        with planted:
            result = harness.run_cell(cell, seed, 0.0, False, device=device,
                                      precision=precision, warm_up=n == 0)
        line = {"workload": args.workload, "reading": kind,
                "seed": seed, "correct": result["correct"],
                "check": result["check"],
                "centroid_gap_by_k": result["centroid_gap_by_k"],
                "seconds": time.perf_counter() - t0,
                "check_s": result["seconds"]["check"],
                "sweep_s": result["seconds"]["sweeps"]}
        print(json.dumps(line), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
