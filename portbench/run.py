"""The benchmark's command: one run of one cell.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

Prints the run's result as the last line of standard output: one JSON
object with ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer ones),
``device`` and, traced, ``breakdown``; ``check`` last, each compared
number beside its limit (also the last lines of standard error).  Exits
non-zero, printing no result, without as many CUDA devices as the cell
asks for, without the program beside this directory, or when a module of
JAX or of the JAX package is loaded once the window has closed.

A cell whose traffic spans processes runs as that many ranks, one card
each (:mod:`portbench.ranks`); this process starts them, waits for them
and prints rank 0's result, or exits non-zero when a rank does or the
ranks outlive their limits.  ``--precision tf32`` (the control) and
``--fault <name>`` (:mod:`portbench.faults`) are for the readings the
limits were set from: the check must refuse both.
"""

import argparse
import contextlib
import json
import os
import sys
import time

T_START = time.perf_counter()
T0_MONOTONIC = time.monotonic()
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from portbench import harness  # noqa: E402


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    parser.add_argument("--precision", choices=("float32", "tf32"),
                        default="float32",
                        help="tf32: the lower-precision control, which the "
                             "check must refuse")
    parser.add_argument("--fault",
                        help="a fault of portbench/faults.py planted in the "
                             "program, which the check must refuse")
    args = parser.parse_args(argv)
    harness.set_environment()
    try:
        cell = harness.load_cell(args.workload)
    except harness.CellError as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 2
    if cell["processes"] > 1:
        return _launch(cell, args)
    import torch

    if not torch.cuda.is_available() or (
            torch.cuda.device_count() < int(cell["chips"])):
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: {args.workload} needs {cell['chips']} CUDA "
              f"device(s); this machine has {have}", file=sys.stderr)
        return 2
    try:
        import consensus_clustering_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"portbench: the program is not beside the benchmark: {e}",
              file=sys.stderr)
        return 2
    from portbench import faults

    planted = (faults.FAULTS[args.fault]() if args.fault
               else contextlib.nullcontext())
    with planted:
        result = harness.run_cell(cell, args.seed, args.seconds,
                                  bool(args.trace), t_start=T_START,
                                  precision=args.precision)
    return _report(result)


def _launch(cell, args) -> int:
    from portbench import ranks

    code, result = ranks.launch(cell, args.seed, args.seconds,
                                bool(args.trace), precision=args.precision,
                                fault=args.fault, t0=T0_MONOTONIC)
    if code:
        return code
    for name, v in result["check"].items():
        ok = "ok" if v["value"] <= v["limit"] else "FAIL"
        print(f"check {name} {v['value']!r} limit {v['limit']!r} {ok}",
              file=sys.stderr)
    return _report(result)


def _report(result) -> int:
    loaded = harness.forbidden_modules()
    if loaded:
        print(f"portbench: modules of JAX or of the JAX package are loaded: "
              f"{loaded}", file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
