# Ported from consensus_clustering_tpu/serve/admin.py.
"""serve-admin: operator tooling over a jobstore directory.

The quarantine release surface (docs/SERVING.md "Overload & wedge
runbook").  A crash-looping job is quarantined by the scheduler's
startup reconciliation — payload and checkpoint ring retained, never
auto-requeued — and the ONLY way back into the queue is this explicit
release: an operator decision, because the last N attempts each killed
the service.

    python -m consensus_clustering_tpu_torch serve-admin --store-dir DIR list
    python -m consensus_clustering_tpu_torch serve-admin --store-dir DIR show JOB_ID
    python -m consensus_clustering_tpu_torch serve-admin --store-dir DIR release JOB_ID
    python -m consensus_clustering_tpu_torch serve-admin --store-dir DIR \
        profile-next TRACE_DIR
    python -m consensus_clustering_tpu_torch serve-admin --store-dir DIR \
        trace JOB_ID --events EVENTS.jsonl
    python -m consensus_clustering_tpu_torch serve-admin --store-dir DIR \
        report --events EVENTS.jsonl [--since TS] [--until TS]
    python -m consensus_clustering_tpu_torch serve-admin --store-dir DIR \
        bundle JOB_ID --events EVENTS.jsonl [--out X.tar.gz] \
        [--metrics-url http://HOST:PORT/metrics]

``list``/``show`` also render each job's LEASE — owner worker, fencing
token, expiry, and a computed state (``live`` | ``expired`` |
``released`` | ``torn``) — straight from the store's
``leases/<job_id>/token-*.json`` files (docs/SERVING.md "Multi-worker
runbook"): who owns a job is exactly the question an operator asks
while one worker of a shared-store fleet is wedged.

``trace``/``report``/``bundle`` are the forensic query engine
(:mod:`consensus_clustering_tpu_torch.obs.query`, docs/OBSERVABILITY.md
"Query engine") over the service's JSONL event log: ``trace`` renders
one job's lifecycle + span tree, ``report`` aggregates per-bucket
p50/p95/p99 latency, per-priority and per-tenant fair-share rows
(docs/SERVING.md "Fair-share & fusion runbook"), and
retry/wedge/drift/SLO breakdowns over a time
range, and ``bundle`` cuts a shareable tar.gz capsule for one job
(record, events slice, spans, rendered trace, optional live /metrics
snapshot, environment fingerprint — NEVER the data matrix).  All three
honour the serve-admin stdlib contract below: they must work while a
backend is wedged.

``profile-next`` arms a ONE-SHOT ``torch.profiler`` trace: the live
service claims the arm before its next executed job and runs that job's
first attempt under the profiler (CUDA activity on the card), writing
a chrome trace into ``TRACE_DIR`` and emitting a ``profile_captured``
event.  Unlike ``release`` it takes effect on a RUNNING service — the
scheduler polls the control file per job — which is the point: a
profile of a loaded service without restarting it.

``release`` resets the payload's restart counter and flips the record
back to ``queued``; the NEXT service start over the store re-queues it
through the normal reconciliation path (and its surviving checkpoint
ring resumes whatever progress the attempts made).  Run it against a
STOPPED service: a live scheduler only reconciles at startup, so a
release under a running service sits inert until the next restart —
``release`` prints exactly that so nobody waits on a poll that will
never flip.

Deliberately STDLIB-ONLY on its own path — it operates on the store's
JSON files directly instead of importing the engine (``api``,
``parallel``, ``ops``) or the executor: this tool exists for exactly
the moments the card is wedged or the service is crash-looping, and
must never initialise CUDA to do its job.  (The package ``__init__``
imports torch, which creates no CUDA context.)  The file formats it
touches (job records; the payload JSON envelope with
``restart_attempts``) are the jobstore's own, written with the same
write-temp + ``os.replace`` discipline; tests/test_torch_admin.py
round-trips both against a real ``JobStore`` so the two
implementations cannot drift silently, and a subprocess test pins that
no engine module is imported and CUDA stays uninitialised.
"""

from __future__ import annotations

import json
import os
import sys
import time
import uuid
from typing import Any, Dict, List, Optional, Tuple

# Stdlib-only by design (the module docstring's contract): serve.leases
# imports nothing beyond the stdlib, and the serve package __init__ is
# lazy — the subprocess pin in tests/test_torch_admin.py holds this line
# to that claim.
from consensus_clustering_tpu_torch.serve.leases import (
    lease_state_name,
    read_lease,
)


def _atomic_write_json(path: str, payload: Dict[str, Any]) -> None:
    # Same unique-temp + rename rule as the jobstore: two writers must
    # never rename each other's half-written temp out from under them.
    tmp = f"{path}.{uuid.uuid4().hex}.tmp"
    with open(tmp, "w") as f:
        json.dump(payload, f, sort_keys=True, default=float)
    os.replace(tmp, path)


def _load_json(path: str) -> Optional[Dict[str, Any]]:
    try:
        with open(path) as f:
            return json.load(f)
    except (FileNotFoundError, ValueError):
        return None


def _job_path(store_dir: str, job_id: str) -> str:
    # The jobstore's traversal guard, duplicated verbatim: a crafted id
    # must not escape the store directory here either.
    if not job_id.replace("-", "").isalnum():
        raise ValueError(f"invalid job id {job_id!r}")
    return os.path.join(store_dir, "jobs", f"{job_id}.json")


def _payload_json_path(store_dir: str, job_id: str) -> str:
    if not job_id.replace("-", "").isalnum():
        raise ValueError(f"invalid job id {job_id!r}")
    return os.path.join(store_dir, "payloads", f"{job_id}.json")


def load_job(store_dir: str, job_id: str) -> Optional[Dict[str, Any]]:
    try:
        return _load_json(_job_path(store_dir, job_id))
    except ValueError:
        return None


def _load_payload_envelope(
    store_dir: str, job_id: str
) -> Optional[Tuple[Dict[str, Any], int]]:
    """(spec payload, restart_attempts) from the payload JSON —
    understanding both the envelope format and the pre-envelope plain
    spec dict (attempts 0)."""
    raw = _load_json(_payload_json_path(store_dir, job_id))
    if raw is None:
        return None
    if isinstance(raw, dict) and "spec" in raw and "restart_attempts" in raw:
        return raw["spec"], int(raw["restart_attempts"])
    return raw, 0


def lease_state(store_dir: str, job_id: str) -> Optional[Dict[str, Any]]:
    """The newest lease for a job, from the store's JSON alone, with a
    computed human ``state``: ``live`` | ``expired`` | ``released`` |
    ``torn``.  ``None`` when the job has never been leased (pre-lease
    stores, or ``--no-leases`` deployments).  Stdlib-only like the rest
    of this tool — who owns a job is exactly the question an operator
    asks while a worker is wedged (docs/SERVING.md "Multi-worker
    runbook")."""
    lease = read_lease(os.path.join(store_dir, "leases"), job_id)
    if lease is None:
        return None
    lease = dict(lease)
    # The scheduler's own classifier: what this renders can never
    # disagree with the takeover decision the fleet actually makes.
    lease["state"] = lease_state_name(lease, time.time())
    return lease


def _lease_column(store_dir: str, job_id: str) -> str:
    lease = lease_state(store_dir, job_id)
    if lease is None:
        return "lease=-"
    return (
        f"lease={lease.get('worker_id') or '?'}"
        f"@{lease.get('token')}({lease['state']})"
    )


def quarantined_jobs(store_dir: str) -> List[Dict[str, Any]]:
    """Every quarantined record in the store, oldest first."""
    jobs_dir = os.path.join(store_dir, "jobs")
    out = []
    try:
        names = sorted(os.listdir(jobs_dir))
    except FileNotFoundError:
        return []
    for name in names:
        if not name.endswith(".json"):
            continue
        record = _load_json(os.path.join(jobs_dir, name))
        if record is not None and record.get("status") == "quarantined":
            out.append(record)
    out.sort(key=lambda r: r.get("quarantined_at", 0))
    return out


def release_job(store_dir: str, job_id: str) -> Dict[str, Any]:
    """Flip a quarantined job back to ``queued`` with a zeroed restart
    counter; returns the updated record.

    Raises ``KeyError`` for an unknown job, ``ValueError`` when the job
    is not quarantined (releasing a live or completed job would corrupt
    its lifecycle) or its payload is gone (nothing left to re-run —
    the record is all that survived).
    """
    record = load_job(store_dir, job_id)
    if record is None:
        raise KeyError(f"unknown job {job_id!r}")
    if record.get("status") != "quarantined":
        raise ValueError(
            f"job {job_id} is {record.get('status')!r}, not quarantined "
            "— only quarantined jobs can be released"
        )
    payload = _load_payload_envelope(store_dir, job_id)
    npy = os.path.join(store_dir, "payloads", f"{job_id}.npy")
    if payload is None or not os.path.exists(npy):
        raise ValueError(
            f"job {job_id} has no usable payload — it cannot be re-run "
            "(the quarantine retains payloads, so this store was "
            "modified externally)"
        )
    spec_payload, _attempts = payload
    # Zero the counter FIRST: if this process dies between the two
    # writes, the job is still quarantined (safe) rather than queued
    # with a stale counter (would re-quarantine after one restart).
    _atomic_write_json(
        _payload_json_path(store_dir, job_id),
        {"spec": spec_payload, "restart_attempts": 0},
    )
    record.update(status="queued", released_at=round(time.time(), 3))
    record.pop("error", None)
    record.pop("quarantined_at", None)
    _atomic_write_json(_job_path(store_dir, job_id), record)
    return record


def arm_profile_next(store_dir: str, profile_dir: str) -> str:
    """Write the one-shot profile-next control file (stdlib mirror of
    ``JobStore.arm_profile`` — same path, same atomic-rename rule, so
    the two implementations cannot drift without a test catching it).
    Returns the control-file path."""
    control_dir = os.path.join(store_dir, "control")
    os.makedirs(control_dir, exist_ok=True)
    path = os.path.join(control_dir, "profile_next.json")
    _atomic_write_json(
        path,
        {
            "profile_dir": os.path.abspath(profile_dir),
            "armed_at": round(time.time(), 3),
        },
    )
    return path


def add_arguments(parser) -> None:
    parser.add_argument(
        "--store-dir", required=True,
        help="the service's jobstore directory",
    )
    sub = parser.add_subparsers(dest="admin_cmd", required=True)
    sub.add_parser(
        "list", help="list quarantined jobs (id, restarts, when, error, "
        "lease owner/state)"
    )
    show = sub.add_parser(
        "show", help="print one job's full record plus its lease "
        "(owner, fencing token, expiry) when one exists"
    )
    show.add_argument("job_id")
    show.add_argument(
        "--devices", type=int, default=None, metavar="D",
        help="also render the estimator's per-device mesh-sharded "
        "footprint for a D-device ('h', 'n') mesh (pure arithmetic — "
        "the stdlib pin holds; outputs are bit-identical sharded, so "
        "this is a capacity view, not a result change)",
    )
    release = sub.add_parser(
        "release",
        help="re-queue a quarantined job (restart counter zeroed; takes "
        "effect at the next service start over this store)",
    )
    release.add_argument("job_id")
    profile = sub.add_parser(
        "profile-next",
        help="arm a one-shot torch.profiler trace of the NEXT job the "
        "live service executes, written into PROFILE_DIR (the service "
        "claims the arm per job — no restart needed)",
    )
    profile.add_argument("profile_dir", metavar="PROFILE_DIR")
    trace = sub.add_parser(
        "trace",
        help="render one job's lifecycle + span tree from the JSONL "
        "event log (trace_id == job_id; offline, stdlib-only)",
    )
    trace.add_argument("job_id")
    trace.add_argument(
        "--events", required=True, metavar="EVENTS.jsonl",
        help="the service's --events-path file",
    )
    report = sub.add_parser(
        "report",
        help="per-bucket p50/p95/p99 latency, per-priority and "
        "per-tenant rows (done/failed/cancelled/shed/p95 queue-wait "
        "— the fair-share lanes), per-worker capacity/steal rows "
        "merged with the store's live fleet/ heartbeats, and "
        "retry/wedge/drift/SLO breakdowns over a time range of the "
        "JSONL event log",
    )
    report.add_argument(
        "--events", required=True, metavar="EVENTS.jsonl",
        help="the service's --events-path file",
    )
    report.add_argument(
        "--since", type=float, default=None, metavar="UNIX_TS",
        help="ignore events before this unix timestamp",
    )
    report.add_argument(
        "--until", type=float, default=None, metavar="UNIX_TS",
        help="ignore events after this unix timestamp",
    )
    report.add_argument(
        "--json", action="store_true", dest="report_json",
        help="emit the report as JSON instead of text",
    )
    bundle = sub.add_parser(
        "bundle",
        help="cut a forensic tar.gz for one job: record, events slice, "
        "spans, rendered trace, optional live /metrics snapshot, env "
        "fingerprint — never the data matrix",
    )
    bundle.add_argument("job_id")
    bundle.add_argument(
        "--events", default=None, metavar="EVENTS.jsonl",
        help="the service's --events-path file (omit for a "
        "record-only bundle)",
    )
    bundle.add_argument(
        "--out", default=None, metavar="OUT.tar.gz",
        help="output path (default: <job_id>-bundle.tar.gz)",
    )
    bundle.add_argument(
        "--metrics-url", default=None, metavar="URL",
        help="live service /metrics endpoint to snapshot into the "
        "bundle (fetch failure is non-fatal — the service may be the "
        "thing being debugged)",
    )


def _footprints_view(
    store_dir: str, job_id: str, record: Dict[str, Any],
    devices: Optional[int] = None,
) -> Dict[str, Any]:
    """The three admission footprint models for a stored job — dense
    vs packed vs estimator — rendered (never persisted) into the
    ``show`` view.  The PR-11 "decide without a second round-trip"
    contract extended to the packed representation: an operator looking
    at a queued/quarantined job sees every engine's predicted bytes
    next to each other — the numbers the 413 body would disclose under
    the DEFAULT block-size policy (the job's ``stream_h_block`` pin is
    honoured; a calibrated autotune block can shift the scheduler's
    own gate slightly, and resolving that store needs the executor this
    stdlib view must not import).  The byte models are the port's own
    (priced for its layouts on the card), not the reference's.  Empty
    when the job's payload or shape is unavailable (externally modified
    store) — ``show`` must never fail over telemetry.  preflight imports
    neither torch nor the engine, so the serve-admin pin holds.
    """
    shape = record.get("shape")
    envelope = _load_payload_envelope(store_dir, job_id)
    if envelope is None or not shape or len(shape) != 2:
        return {}
    spec, _attempts = envelope
    try:
        from consensus_clustering_tpu_torch.serve.preflight import (
            estimate_estimator_bytes,
            estimate_estimator_sharded,
            estimate_job_bytes,
            estimate_packed_bytes,
        )

        n, d = int(shape[0]), int(shape[1])
        k_values = [int(k) for k in spec.get("k_values") or [2]]
        # The default-policy block size (config.autotune_stream_block's
        # H/8 clamped [16, 128] — replicated here to keep config, and
        # numpy behind it, off the stdlib-pinned admin path).
        h_block = spec.get("stream_h_block") or max(
            16, min(128, int(spec.get("n_iterations", 25)) // 8)
        )
        kwargs = dict(
            dtype=spec.get("dtype", "float32"),
            h_block=int(h_block),
            subsampling=float(spec.get("subsampling", 0.8)),
        )
        estimator = estimate_estimator_bytes(
            n, d, k_values,
            n_pairs=spec.get("n_pairs"),
            accum_repr=spec.get("accum_repr", "dense"),
            **kwargs,
        )
        if devices is not None and devices >= 2:
            # The mesh-sharded per-device view + mesh hint next to the
            # single-device model: sharding is bit-identical, so a job
            # too big solo can be read off as "fits over D devices".
            estimator = dict(estimator)
            estimator["sharded"] = estimate_estimator_sharded(
                estimator, devices
            )
        return {
            "footprints": {
                "dense": estimate_job_bytes(n, d, k_values, **kwargs),
                "packed": estimate_packed_bytes(
                    n, d, k_values,
                    n_iterations=int(spec.get("n_iterations", 25)),
                    **kwargs,
                ),
                "estimator": estimator,
            }
        }
    except Exception:  # noqa: BLE001 — a sizing-model hiccup must not
        return {}  # take down the operator's forensic view


def cmd_serve_admin(args) -> int:
    if args.admin_cmd == "list":
        jobs = quarantined_jobs(args.store_dir)
        if not jobs:
            print("no quarantined jobs")
            return 0
        for record in jobs:
            print(
                f"{record['job_id']}  "
                f"restarts={record.get('restart_requeues', '?')}  "
                f"quarantined_at={record.get('quarantined_at', '?')}  "
                f"fingerprint={record.get('fingerprint', '?')}  "
                + _lease_column(args.store_dir, record["job_id"])
            )
        return 0
    if args.admin_cmd == "show":
        record = load_job(args.store_dir, args.job_id)
        if record is None:
            print(f"unknown job {args.job_id}", file=sys.stderr)
            return 1
        # The record plus its lease (rendered, never written back: the
        # "lease" key exists only in this view — the record file stays
        # exactly what the scheduler wrote).
        out = dict(record)
        lease = lease_state(args.store_dir, args.job_id)
        if lease is not None:
            out["lease"] = lease
        out.update(_footprints_view(
            args.store_dir, args.job_id, record,
            devices=getattr(args, "devices", None),
        ))
        print(json.dumps(out, indent=1, sort_keys=True, default=float))
        return 0
    if args.admin_cmd == "release":
        try:
            record = release_job(args.store_dir, args.job_id)
        except (KeyError, ValueError) as e:
            print(f"release refused: {e}", file=sys.stderr)
            return 1
        print(
            f"released {args.job_id}: status=queued, restart counter "
            "zeroed. It will be re-queued by the NEXT service start "
            "over this store (a running service only reconciles at "
            "startup)."
        )
        print(json.dumps(record, indent=1, sort_keys=True, default=float))
        return 0
    if args.admin_cmd == "profile-next":
        path = arm_profile_next(args.store_dir, args.profile_dir)
        print(
            f"armed: the NEXT job the live service executes will run "
            f"its first attempt under a torch.profiler trace into "
            f"{os.path.abspath(args.profile_dir)} (control file "
            f"{path}; one-shot — re-arm for another capture). Watch "
            "for the profile_captured event."
        )
        return 0
    if args.admin_cmd == "trace":
        # The query engine is stdlib-only like everything the obs
        # package exports — imported here so list/show/release stay as
        # light as they always were.
        from consensus_clustering_tpu_torch.obs.query import (
            load_events,
            render_trace,
        )

        try:
            events = load_events(args.events)
        except OSError as e:
            print(f"cannot read events log: {e}", file=sys.stderr)
            return 1
        print(render_trace(events, args.job_id))
        return 0
    if args.admin_cmd == "report":
        from consensus_clustering_tpu_torch.obs.query import (
            load_events,
            render_report,
            summarize,
        )

        try:
            # Time bounds applied at the reader: a long-lived service's
            # log need not be materialized past the requested range.
            events = load_events(
                args.events, since=args.since, until=args.until
            )
        except OSError as e:
            print(f"cannot read events log: {e}", file=sys.stderr)
            return 1
        # store_dir folds the live fleet/ heartbeats into the report's
        # fleet rows — capacity NOW next to the log's steal history
        # (docs/SERVING.md "Fleet runbook"); stdlib-only, so the admin
        # pin holds.
        report = summarize(
            events, since=args.since, until=args.until,
            store_dir=args.store_dir,
        )
        if args.report_json:
            print(json.dumps(report, indent=1, sort_keys=True))
        else:
            print(render_report(report))
        return 0
    if args.admin_cmd == "bundle":
        from consensus_clustering_tpu_torch.obs.query import build_bundle

        if args.events is not None and not os.path.isfile(args.events):
            # The sibling trace/report error here too: a mistyped
            # --events during an incident must not silently cut a
            # capsule with no events/spans/trace/report members
            # (omitting --events entirely still cuts the documented
            # record-only bundle).
            print(
                f"cannot read events log: {args.events}",
                file=sys.stderr,
            )
            return 1
        metrics_text = None
        if args.metrics_url:
            # Best-effort: the bundle is cut during incidents, and the
            # service being down is not a reason to lose the capsule.
            import urllib.request

            try:
                with urllib.request.urlopen(
                    args.metrics_url, timeout=10
                ) as r:
                    metrics_text = r.read().decode()
            except Exception as e:  # noqa: BLE001 — non-fatal by design
                print(
                    f"warning: /metrics snapshot skipped ({e})",
                    file=sys.stderr,
                )
        out_path = args.out or f"{args.job_id}-bundle.tar.gz"
        try:
            members = build_bundle(
                args.store_dir, args.events, args.job_id, out_path,
                metrics_text=metrics_text,
            )
        except OSError as e:
            print(f"bundle failed: {e}", file=sys.stderr)
            return 1
        print(f"wrote {os.path.abspath(out_path)}:")
        for name in members:
            print(f"  {name}")
        print("(no data matrix — bundles are for sharing)")
        return 0
    return 2
