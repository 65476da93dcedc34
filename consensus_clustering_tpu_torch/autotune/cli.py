# Ported from consensus_clustering_tpu/autotune/cli.py.
"""``python -m consensus_clustering_tpu_torch autotune run|show|diff``.

The measurement front door: ``run`` executes the parity-gated probe
suite (:mod:`.probes`) under a ``--budget`` seconds cap on ``--device``
(``cuda`` unless ``cpu`` is asked for) and prints one JSON summary line,
``show`` lists a store's records, ``diff`` compares two stores'
recommendations.  The serving curve on the card is one command:

    python -m consensus_clustering_tpu_torch autotune run --shapes full \
        --probe stream_h_block --store calibration --budget 900

``--store`` defaults to ``CCTPU_CALIBRATION_DIR``; the port has no
committed store (the reference's seed records were measured on another
stack, and its fingerprints refuse them anyway), so without either the
command exits 2.

Exit codes (``run``): 0 = every executed gate passed (budget-skips are
fine), 1 = a parity gate failed (a recommendation's correctness premise
broke), 2 = usage.
"""

from __future__ import annotations

import json
import sys
from typing import Any, Dict


def add_arguments(parser) -> None:
    sub = parser.add_subparsers(dest="autotune_cmd", required=True)

    run = sub.add_parser(
        "run", help="run the parity-gated probe suite"
    )
    run.add_argument(
        "--store", default=None,
        help="calibration store directory (default: "
        "CCTPU_CALIBRATION_DIR)",
    )
    run.add_argument(
        "--probe", action="append", default=None, metavar="NAME",
        help="run only this probe (repeatable; default: all). "
        "Available: max_iter, cluster_batch, split_init, "
        "stream_h_block, adaptive_tol",
    )
    run.add_argument(
        "--budget", type=float, default=None, metavar="SECONDS",
        help="wall-clock cap: measurements that don't fit are reported "
        "budget-skipped, never half-run (default: unbounded)",
    )
    run.add_argument(
        "--shapes", choices=["smoke", "small", "full"], default="small",
        help="probe shape scale: smoke (seconds), small (CPU "
        "minutes), full (the bench shapes, for the card)",
    )
    run.add_argument("--seed", type=int, default=23)
    run.add_argument(
        "--repeats", type=int, default=1,
        help="run each fit this many times and time the fastest (>1 "
        "filters a shared host's noise)",
    )
    run.add_argument(
        "--device", default=None,
        help="torch device the probes run on (default: cuda, which "
        "needs a GPU; cpu runs the kernels' plain versions)",
    )

    show = sub.add_parser("show", help="list a store's records")
    show.add_argument("--store", default=None)
    show.add_argument(
        "--this-env-only", action="store_true",
        help="only records the current environment would resolve",
    )

    diff = sub.add_parser(
        "diff", help="compare two stores' recommendations"
    )
    diff.add_argument("--store", default=None)
    diff.add_argument(
        "--against", required=True,
        help="the other store directory to compare with",
    )


def _store_dir(args) -> str:
    if args.store:
        return args.store
    from consensus_clustering_tpu_torch.autotune.policy import (
        default_calibration_dir,
    )

    directory = default_calibration_dir()
    if directory is None:
        print("autotune: no calibration store: pass --store DIR or set "
              "CCTPU_CALIBRATION_DIR", file=sys.stderr)
        raise SystemExit(2)
    return directory


def cmd_autotune(args) -> int:
    return {"run": _cmd_run, "show": _cmd_show, "diff": _cmd_diff}[
        args.autotune_cmd
    ](args)


def _cmd_run(args) -> int:
    from consensus_clustering_tpu_torch.autotune.probes import (
        Budget,
        ProbeContext,
        get_probe,
        list_probes,
        run_probes,
    )
    from consensus_clustering_tpu_torch.autotune.store import (
        CalibrationStore,
        environment,
    )
    from consensus_clustering_tpu_torch.device import resolve_device

    names = args.probe or [p.name for p in list_probes()]
    try:
        for name in names:
            get_probe(name)
    except KeyError as e:
        print(f"autotune: {e.args[0]}", file=sys.stderr)
        return 2
    if args.repeats < 1:
        print("autotune: --repeats must be >= 1", file=sys.stderr)
        return 2
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        print(f"autotune: {e}", file=sys.stderr)
        return 2
    store = CalibrationStore(_store_dir(args), env=environment(device))
    ctx = ProbeContext(
        store=store,
        budget=Budget(args.budget),
        shapes=args.shapes,
        seed=args.seed,
        repeats=args.repeats,
        device=str(device),
    )
    summaries, gate_failed = run_probes(names, ctx)
    payload: Dict[str, Any] = {
        "store": store.directory,
        "env": store.env,
        "env_fingerprint": store.env_fp,
        "shapes": args.shapes,
        "device": str(device),
        "budget_seconds": args.budget,
        "elapsed_seconds": round(ctx.budget.elapsed(), 1),
        "records_written": sum(len(s["records"]) for s in summaries),
        "gate_failed": gate_failed,
        "probes": summaries,
    }
    print(json.dumps(payload))
    return 1 if gate_failed else 0


def _cmd_show(args) -> int:
    from consensus_clustering_tpu_torch.autotune.store import CalibrationStore

    store = CalibrationStore(_store_dir(args))
    records = store.records(all_envs=not args.this_env_only)
    print(json.dumps({
        "store": store.directory,
        "current_env_fingerprint": store.env_fp,
        "records": [
            dict(record, path=path) for path, record in records
        ],
    }, indent=1))
    return 0


def _cmd_diff(args) -> int:
    from consensus_clustering_tpu_torch.autotune.store import CalibrationStore

    a = CalibrationStore(_store_dir(args))
    b = CalibrationStore(args.against)

    def _index(store):
        out = {}
        for path, record in store.records(all_envs=True):
            if "error" in record:
                continue
            key = (
                record["env_fingerprint"], record["knob"],
                record["bucket"],
            )
            out[key] = record
        return out

    ia, ib = _index(a), _index(b)
    diffs = []
    for key in sorted(set(ia) | set(ib)):
        ra, rb = ia.get(key), ib.get(key)
        if ra is not None and rb is not None:
            if ra.get("value") != rb.get("value"):
                diffs.append({
                    "env_fingerprint": key[0], "knob": key[1],
                    "bucket": key[2], "status": "value-differs",
                    "value_a": ra.get("value"), "value_b": rb.get("value"),
                })
        else:
            diffs.append({
                "env_fingerprint": key[0], "knob": key[1],
                "bucket": key[2],
                "status": "only-in-a" if rb is None else "only-in-b",
            })
    print(json.dumps({
        "store_a": a.directory,
        "store_b": b.directory,
        "records_a": len(ia),
        "records_b": len(ib),
        "differences": diffs,
    }, indent=1))
    return 0
