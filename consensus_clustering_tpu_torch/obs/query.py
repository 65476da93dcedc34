# Copied from consensus_clustering_tpu/obs/query.py.
"""Forensic query engine over the serve JSONL event log.

The serving subsystem's one durable telemetry stream is the EventLog
JSONL file: lifecycle events, trace spans, drift/SLO/integrity verdicts
all ride it (docs/OBSERVABILITY.md).  This module turns that file back
into answers, offline, with nothing but the stdlib — it is the engine
behind ``serve-admin trace``/``report``/``bundle``, tools that exist for
exactly the moments the device stack is wedged (the serve-admin
contract: no jax, no numpy, pinned by a ``-X importtime`` test).

- :func:`render_trace`   — one job's whole story: its lifecycle events
  in order plus the span tree (``queue_wait`` → ``attempt`` →
  ``compile``/``execute`` → per-block children), reconstructed purely
  from ``span`` events (trace_id == job_id);
- :func:`summarize` / :func:`render_report` — per-bucket p50/p95/p99
  latency, retry/wedge/drift/SLO/integrity breakdowns over a time
  range (the post-incident "what happened while I slept" view);
- :func:`build_bundle`   — a tar.gz forensic capsule for one job: its
  jobstore record, its events slice, its spans, an optional live
  ``/metrics`` snapshot, and an environment fingerprint — explicitly
  WITHOUT the data matrix (bundles travel to people who should not
  receive the data).

Every reader is tolerant of torn/garbage lines (a crash mid-append is
exactly the situation this tooling serves) — bad lines are counted, not
fatal.
"""

from __future__ import annotations

import io
import json
import math
import os
import platform
import socket
import sys
import tarfile
import time
from typing import Any, Dict, Iterable, Iterator, List, Optional, Tuple

#: Lifecycle event names rendered in a job's story (everything keyed by
#: job_id that is not a span).
_LIFECYCLE_SKIP_FIELDS = ("ts", "event", "job_id")


def iter_events(path: str) -> Iterator[Dict[str, Any]]:
    """Yield parsed events from a JSONL log, skipping unparseable lines
    (a torn tail from a crash mid-append must not kill the forensic
    tool that exists to investigate that crash).  ``errors="replace"``
    for the same reason: a torn line can hold invalid UTF-8 bytes, and
    a decode crash here is the one failure mode this reader exists to
    survive — the mangled line then just fails the JSON parse."""
    with open(path, encoding="utf-8", errors="replace") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                event = json.loads(line)
            except ValueError:
                continue
            if isinstance(event, dict):
                yield event


def load_events(
    path: str,
    since: Optional[float] = None,
    until: Optional[float] = None,
) -> List[Dict[str, Any]]:
    """Events in [since, until] (unix seconds; None = unbounded)."""
    out = []
    for event in iter_events(path):
        ts = event.get("ts")
        if since is not None and (ts is None or ts < since):
            continue
        if until is not None and (ts is None or ts > until):
            continue
        out.append(event)
    return out


def job_events(
    events: Iterable[Dict[str, Any]], job_id: str
) -> Tuple[List[Dict[str, Any]], List[Dict[str, Any]]]:
    """(lifecycle events, spans) for one job, log order preserved.
    Spans are matched on ``trace_id`` (== job_id for serve jobs),
    lifecycle events on ``job_id``."""
    lifecycle: List[Dict[str, Any]] = []
    spans: List[Dict[str, Any]] = []
    for event in events:
        if event.get("event") == "span":
            if event.get("trace_id") == job_id:
                spans.append(event)
        elif event.get("job_id") == job_id:
            lifecycle.append(event)
    return lifecycle, spans


def percentile(values: List[float], q: float) -> Optional[float]:
    """Nearest-rank percentile (q in (0, 1]) of an unsorted list.  The
    epsilon guards float artefacts like ``0.95 * 20 == 19.000000000004``
    rounding the rank up a slot."""
    if not values:
        return None
    ordered = sorted(values)
    rank = max(1, math.ceil(q * len(ordered) - 1e-9))
    return ordered[min(len(ordered), rank) - 1]


# ---------------------------------------------------------------------------
# trace: one job's span tree


def build_span_tree(
    spans: List[Dict[str, Any]]
) -> List[Dict[str, Any]]:
    """Span events → forest of ``{"span": ..., "children": [...]}``
    nodes.  Spans are emitted at END with ``seconds``, so a child's
    START (ts - seconds) orders siblings; orphans (parent id never
    emitted — e.g. an abandoned attempt whose parent span was dropped
    by the generation guard) surface as extra roots rather than being
    hidden."""
    nodes = {
        s.get("span_id"): {"span": s, "children": []} for s in spans
    }

    def start(node):
        s = node["span"]
        return (s.get("ts") or 0.0) - (s.get("seconds") or 0.0)

    roots = []
    for node in nodes.values():
        parent = nodes.get(node["span"].get("parent_span_id"))
        if parent is not None and parent is not node:
            parent["children"].append(node)
        else:
            roots.append(node)
    for node in nodes.values():
        node["children"].sort(key=start)
    roots.sort(key=start)
    return roots


def _span_label(span: Dict[str, Any]) -> str:
    skip = {
        "name", "trace_id", "span_id", "parent_span_id", "seconds",
        "status", "ts", "event",
    }
    detail = " ".join(
        f"{k}={span[k]}" for k in sorted(span) if k not in skip
    )
    status = span.get("status", "ok")
    line = f"{span.get('name', '?')}  {span.get('seconds', 0):.3f}s"
    if status != "ok":
        line += f"  [{status}]"
    if detail:
        line += f"  ({detail})"
    return line


def render_trace(
    events: Iterable[Dict[str, Any]], job_id: str
) -> str:
    """One job's story as text: lifecycle lines, then the span tree."""
    lifecycle, spans = job_events(events, job_id)
    lines = [f"trace {job_id}"]
    if not lifecycle and not spans:
        lines.append("  (no events for this job in the log)")
        return "\n".join(lines)
    lines.append("")
    lines.append("lifecycle:")
    for event in lifecycle:
        detail = " ".join(
            f"{k}={event[k]}"
            for k in sorted(event) if k not in _LIFECYCLE_SKIP_FIELDS
        )
        ts = event.get("ts")
        stamp = (
            time.strftime("%H:%M:%S", time.localtime(ts))
            if isinstance(ts, (int, float)) else "?"
        )
        lines.append(f"  {stamp}  {event.get('event')}  {detail}")
    lines.append("")
    lines.append(f"spans ({len(spans)}):")

    def walk(node, prefix, last):
        branch = "└─ " if last else "├─ "
        lines.append(prefix + branch + _span_label(node["span"]))
        child_prefix = prefix + ("   " if last else "│  ")
        kids = node["children"]
        for i, child in enumerate(kids):
            walk(child, child_prefix, i == len(kids) - 1)

    roots = build_span_tree(spans)
    for i, root in enumerate(roots):
        walk(root, "  ", i == len(roots) - 1)
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# report: per-bucket percentiles + incident breakdowns


def _lane_row() -> Dict[str, Any]:
    """A fresh per-priority / per-tenant accumulator row."""
    return {
        "done": 0, "failed": 0, "cancelled": 0, "shed": 0,
        "queue_wait": [],
    }


def _live_fleet(store_dir: str) -> Dict[str, Any]:
    """The store's ``fleet/`` heartbeat files as report rows — the same
    digest-verified reader the workers use (stdlib only, so the
    serve-admin no-jax pin holds).  Tolerant of everything: an absent
    directory, torn files, a reader crash all collapse to empty rows —
    the report is a forensic tool and must render from the JSONL alone
    (docs/SERVING.md "Fleet runbook")."""
    try:
        from consensus_clustering_tpu_torch.serve.fleet.heartbeat import (
            read_fleet,
        )

        peers, rejected = read_fleet(
            os.path.join(store_dir, "fleet"),
            now=time.time(),
            # The report has no scheduler config; be generous so a
            # just-stopped fleet still renders (age discloses truth).
            stale_after=900.0,
        )
    except Exception:
        return {"workers": {}, "rejected": 0}
    now = time.time()
    workers = {
        worker: {
            "queue_depth": hb.get("queue_depth"),
            "running": hb.get("running"),
            "drain_rate_per_s": hb.get("drain_rate_per_s"),
            "slo_burn_active": hb.get("slo_burn_active"),
            "age_seconds": (
                round(now - hb["ts"], 1)
                if isinstance(hb.get("ts"), (int, float)) else None
            ),
        }
        for worker, hb in sorted(peers.items())
    }
    return {"workers": workers, "rejected": rejected}


def summarize(
    events: Iterable[Dict[str, Any]],
    since: Optional[float] = None,
    until: Optional[float] = None,
    store_dir: Optional[str] = None,
) -> Dict[str, Any]:
    """Aggregate a (time-sliced) event stream into the operator report.

    Latency percentiles are per shape bucket (``job_done`` events carry
    ``bucket``; ``queue_wait`` spans join to their job's bucket via
    trace_id) because the sweep's long-tail jobs make a global
    percentile dishonest — one big-N job is not a regression.

    ``store_dir`` (optional) additionally merges the live ``fleet/``
    heartbeat files into the fleet section — capacity NOW, next to the
    log's history of steals and scale signals."""
    events = [
        e for e in events
        if (since is None or (e.get("ts") or 0) >= since)
        and (until is None or (e.get("ts") or 0) <= until)
    ]
    statuses: Dict[str, int] = {}
    job_seconds: Dict[str, List[float]] = {}
    bucket_of: Dict[str, str] = {}
    queue_wait_raw: List[Tuple[str, float]] = []  # (trace_id, seconds)
    # Fair-share lane identity per job (docs/SERVING.md "Fair-share &
    # fusion runbook"): job_submitted carries priority + tenant, and
    # the per-priority / per-tenant report rows join everything else
    # through the job_id.  Jobs whose admission predates the log slice
    # (or the lane fields) file under "unknown".
    lane_of: Dict[str, Tuple[str, str]] = {}
    per_priority: Dict[str, Dict[str, Any]] = {}
    per_tenant: Dict[str, Dict[str, Any]] = {}

    def lane_rows(job_id: Optional[str]) -> List[Dict[str, Any]]:
        priority, tenant = lane_of.get(job_id, ("unknown", "unknown"))
        return [
            per_priority.setdefault(priority, _lane_row()),
            per_tenant.setdefault(tenant, _lane_row()),
        ]

    # Progressive serving (docs/SERVING.md "Progressive serving
    # runbook"), reconstructed from the JSONL alone: parents are
    # job_submitted events with mode="progressive"; their first-answer
    # latency is submit→job_done (the banded estimate), exactness
    # latency is submit→result_upgraded (the continuation's refined
    # twin).  Continuation ids come from continuation_enqueued, so
    # their cancels can be told apart from ordinary ones.
    prog_submit_ts: Dict[str, float] = {}
    prog_done_ts: Dict[str, float] = {}
    prog_upgrade_ts: Dict[str, float] = {}
    cont_ids: set = set()
    cont_counts = {
        "enqueued": 0, "completed": 0, "cancelled": 0, "shed": 0,
    }
    # Append serving (docs/SERVING.md "Append runbook"), likewise from
    # the JSONL alone: appends served are job_done events in an
    # ``-append`` bucket; the marginal-vs-full cost ratio rides
    # plane_store_written (append generations carry
    # marginal_lane_fraction; 1.0 = disclosed full-recompute fallback);
    # refresh_recommended events are the staleness verdicts.
    appends_served = 0
    plane_stores_written = 0
    append_fractions: List[float] = []
    refresh_recommended = 0
    refresh_max_excess: Optional[float] = None
    retries: Dict[str, int] = {}
    wedges = 0
    drift: Dict[str, int] = {}
    slo: Dict[str, Dict[str, int]] = {}
    integrity = 0
    preflight_inaccurate: Dict[str, int] = {}
    # Per-worker attribution (docs/SERVING.md "Multi-worker runbook"):
    # job_* events carry worker_id, so a merged log from a shared-store
    # fleet still tells which worker ran — or was refused — what.
    per_worker: Dict[str, Dict[str, int]] = {}
    # Fleet layer (docs/SERVING.md "Fleet runbook"): steals are
    # attributed BOTH ways — the thief's row counts sets/jobs taken,
    # the victim's row counts jobs lost — and the latest scale signal
    # is the operator's autoscale verdict for the slice.
    scale_signals = 0
    last_scale: Optional[Dict[str, Any]] = None
    ts_lo = ts_hi = None

    def named_worker_row(worker: Any) -> Dict[str, int]:
        return per_worker.setdefault(
            str(worker),
            {"done": 0, "failed": 0, "retried": 0, "requeued": 0,
             "takeovers": 0, "refused_writes": 0, "heartbeats": 0,
             "steals": 0, "jobs_stolen": 0, "jobs_lost_to_steal": 0},
        )

    def worker_row(event: Dict[str, Any]) -> Optional[Dict[str, int]]:
        worker = event.get("worker_id")
        if worker is None:
            return None  # pre-lease logs: no fleet, no rows
        return named_worker_row(worker)
    for e in events:
        ts = e.get("ts")
        if isinstance(ts, (int, float)):
            ts_lo = ts if ts_lo is None else min(ts_lo, ts)
            ts_hi = ts if ts_hi is None else max(ts_hi, ts)
        name = e.get("event")
        if name == "span":
            if e.get("name") == "queue_wait":
                queue_wait_raw.append(
                    (e.get("trace_id"), float(e.get("seconds") or 0.0))
                )
            continue
        if name in (
            "job_submitted", "job_done", "job_failed", "job_retry",
            "job_wedged", "job_requeued", "job_quarantined", "job_shed",
            "job_preflight_reject", "job_cancelled",
        ):
            statuses[name] = statuses.get(name, 0) + 1
        if name == "job_submitted":
            if e.get("job_id") and e.get("priority"):
                lane_of[e["job_id"]] = (
                    str(e["priority"]),
                    str(e.get("tenant") or "default"),
                )
            if (
                e.get("mode") == "progressive" and e.get("job_id")
                and isinstance(ts, (int, float))
            ):
                prog_submit_ts[e["job_id"]] = float(ts)
        if name == "job_done":
            jid = e.get("job_id")
            if jid in prog_submit_ts and isinstance(ts, (int, float)):
                prog_done_ts[jid] = float(ts)
            bucket = e.get("bucket") or "unknown"
            if bucket.endswith("-append"):
                appends_served += 1
            if e.get("job_id"):
                bucket_of[e["job_id"]] = bucket
            if e.get("seconds") is not None:
                job_seconds.setdefault(bucket, []).append(
                    float(e["seconds"])
                )
            row = worker_row(e)
            if row is not None:
                row["done"] += 1
            for lane in lane_rows(e.get("job_id")):
                lane["done"] += 1
        elif name == "job_failed":
            # Failed jobs join their queue waits through the bucket
            # too (carried since the job reached worker pickup): an
            # overload whose jobs all fail must still show its backlog
            # per bucket, not vanish from the report.
            if e.get("job_id") and e.get("bucket"):
                bucket_of[e["job_id"]] = e["bucket"]
            row = worker_row(e)
            if row is not None:
                row["failed"] += 1
            for lane in lane_rows(e.get("job_id")):
                lane["failed"] += 1
        elif name == "job_cancelled":
            if e.get("job_id") in cont_ids:
                cont_counts["cancelled"] += 1
            for lane in lane_rows(e.get("job_id")):
                lane["cancelled"] += 1
        elif name == "continuation_enqueued":
            cont_counts["enqueued"] += 1
            if e.get("continuation_job_id"):
                cont_ids.add(e["continuation_job_id"])
        elif name == "result_upgraded":
            cont_counts["completed"] += 1
            jid = e.get("job_id")
            if jid in prog_submit_ts and isinstance(ts, (int, float)):
                prog_upgrade_ts[jid] = float(ts)
        elif name == "job_shed":
            if e.get("continuation_of"):
                cont_counts["shed"] += 1
            # Sheds have no job_id (nothing was admitted): the event's
            # own lane fields are the row keys.
            per_priority.setdefault(
                str(e.get("priority") or "unknown"), _lane_row()
            )["shed"] += 1
            per_tenant.setdefault(
                str(e.get("tenant") or "unknown"), _lane_row()
            )["shed"] += 1
        elif name == "job_retry":
            reason = e.get("reason", "unknown")
            retries[reason] = retries.get(reason, 0) + 1
            row = worker_row(e)
            if row is not None:
                row["retried"] += 1
        elif name == "job_requeued":
            row = worker_row(e)
            if row is not None:
                row["requeued"] += 1
        elif name == "lease_takeover":
            row = worker_row(e)
            if row is not None:
                row["takeovers"] += 1
        elif name == "lease_refused":
            row = worker_row(e)
            if row is not None:
                row["refused_writes"] += 1
        elif name == "work_stolen":
            row = worker_row(e)
            count = int(e.get("count") or 0)
            if row is not None:
                row["steals"] += 1
                row["jobs_stolen"] += count
            if e.get("stolen_from") is not None:
                named_worker_row(e["stolen_from"])[
                    "jobs_lost_to_steal"
                ] += count
        elif name == "fleet_heartbeat_written":
            row = worker_row(e)
            if row is not None:
                row["heartbeats"] += 1
        elif name == "fleet_scale_signal":
            scale_signals += 1
            last_scale = {
                k: e.get(k)
                for k in (
                    "recommendation", "workers_seen", "fleet_backlog",
                    "fleet_running", "fleet_drain_rate_per_s",
                    "est_drain_seconds", "slo_burn_active", "ts",
                )
            }
        elif name == "job_wedged":
            wedges += 1
        elif name == "perf_drift":
            bucket = e.get("bucket", "unknown")
            drift[bucket] = drift.get(bucket, 0) + 1
        elif name == "slo_breach":
            objective = e.get("objective", "unknown")
            bucket = e.get("bucket", "unknown")
            slo.setdefault(objective, {})
            slo[objective][bucket] = slo[objective].get(bucket, 0) + 1
        elif name == "integrity_violation":
            integrity += 1
        elif name == "preflight_inaccurate":
            bucket = e.get("bucket", "unknown")
            preflight_inaccurate[bucket] = (
                preflight_inaccurate.get(bucket, 0) + 1
            )
        elif name == "plane_store_written":
            plane_stores_written += 1
            fraction = e.get("marginal_lane_fraction")
            if isinstance(fraction, (int, float)):
                append_fractions.append(float(fraction))
        elif name == "refresh_recommended":
            refresh_recommended += 1
            excess = e.get("drift_excess")
            if isinstance(excess, (int, float)):
                refresh_max_excess = (
                    float(excess) if refresh_max_excess is None
                    else max(refresh_max_excess, float(excess))
                )
    queue_wait: Dict[str, List[float]] = {}
    for trace_id, seconds in queue_wait_raw:
        # Never drop a wait for lack of a terminal event: a job still
        # running (or killed with the service) at the log's edge is
        # part of the backlog story, filed under "unknown".
        bucket = bucket_of.get(trace_id) or "unknown"
        queue_wait.setdefault(bucket, []).append(seconds)
        for lane in lane_rows(trace_id):
            lane["queue_wait"].append(seconds)

    def stats(values: List[float]) -> Dict[str, Any]:
        return {
            "count": len(values),
            "p50": percentile(values, 0.50),
            "p95": percentile(values, 0.95),
            "p99": percentile(values, 0.99),
            "max": max(values) if values else None,
        }

    # Union of both keys: a bucket with queue waits but zero completed
    # jobs (the wedged-backend overload) still gets a row — its
    # job_seconds render as "-", its queue p95 tells the story.
    per_bucket = {
        bucket: {
            "job_seconds": stats(job_seconds.get(bucket, [])),
            "queue_wait_seconds": stats(queue_wait.get(bucket, [])),
        }
        for bucket in sorted(set(job_seconds) | set(queue_wait))
    }
    def lane_section(
        rows: Dict[str, Dict[str, Any]]
    ) -> Dict[str, Dict[str, Any]]:
        # The fair-share report rows (docs/SERVING.md "Fair-share &
        # fusion runbook"): done/failed/cancelled/shed counts plus the
        # p95 queue wait — the number weighted queues exist to move.
        return {
            key: {
                "done": row["done"],
                "failed": row["failed"],
                "cancelled": row["cancelled"],
                "shed": row["shed"],
                "queue_wait_count": len(row["queue_wait"]),
                "queue_wait_p95": percentile(row["queue_wait"], 0.95),
            }
            for key, row in sorted(rows.items())
        }

    ttfa = [
        max(0.0, prog_done_ts[j] - prog_submit_ts[j])
        for j in prog_done_ts if j in prog_submit_ts
    ]
    tte = [
        max(0.0, prog_upgrade_ts[j] - prog_submit_ts[j])
        for j in prog_upgrade_ts if j in prog_submit_ts
    ]
    return {
        "events": len(events),
        "first_ts": ts_lo,
        "last_ts": ts_hi,
        "jobs": statuses,
        "progressive": {
            "estimates_answered": len(prog_done_ts),
            "continuations": dict(cont_counts),
            "time_to_first_answer": stats(ttfa),
            "time_to_exact": stats(tte),
        },
        "append": {
            "appends_served": appends_served,
            "plane_stores_written": plane_stores_written,
            "marginal_lane_fraction": stats(append_fractions),
            "refresh_recommended": refresh_recommended,
            "max_drift_excess": refresh_max_excess,
        },
        "per_bucket": per_bucket,
        "per_priority": lane_section(per_priority),
        "per_tenant": lane_section(per_tenant),
        "per_worker": {k: per_worker[k] for k in sorted(per_worker)},
        "fleet": {
            "scale_signals": scale_signals,
            "last_scale_signal": last_scale,
            "live": (
                _live_fleet(store_dir) if store_dir is not None
                else None
            ),
        },
        "retries": retries,
        "wedges": wedges,
        "perf_drift": drift,
        "slo_breaches": slo,
        "integrity_violations": integrity,
        "preflight_inaccurate": preflight_inaccurate,
    }


def render_report(report: Dict[str, Any]) -> str:
    """The :func:`summarize` dict as operator-readable text."""
    lines = [
        f"events: {report['events']}"
        + (
            f"  ({time.strftime('%Y-%m-%d %H:%M:%S', time.localtime(report['first_ts']))}"
            f" .. {time.strftime('%H:%M:%S', time.localtime(report['last_ts']))})"
            if report.get("first_ts") is not None else ""
        ),
        "jobs: " + (
            " ".join(
                f"{k.replace('job_', '')}={v}"
                for k, v in sorted(report["jobs"].items())
            ) or "(none)"
        ),
        "",
        "per-bucket latency (seconds):",
    ]
    if not report["per_bucket"]:
        lines.append("  (no completed jobs in range)")
    for bucket, section in report["per_bucket"].items():
        js = section["job_seconds"]
        qs = section["queue_wait_seconds"]

        def fmt(v):
            return "-" if v is None else f"{v:.3f}"

        lines.append(
            f"  {bucket}  n={js['count']}"
            f"  job p50={fmt(js['p50'])} p95={fmt(js['p95'])}"
            f" p99={fmt(js['p99'])} max={fmt(js['max'])}"
            f"  queue p95={fmt(qs['p95'])}"
        )
    def fmt_opt(v):
        return "-" if v is None else f"{v:.3f}"

    for title, key in (
        ("per-priority", "per_priority"), ("per-tenant", "per_tenant")
    ):
        rows = report.get(key) or {}
        if not rows:
            continue
        lines.append("")
        lines.append(f"{title} (docs/SERVING.md fair-share runbook):")
        for name, row in rows.items():
            lines.append(
                f"  {name}  done={row['done']} failed={row['failed']}"
                f" cancelled={row['cancelled']} shed={row['shed']}"
                f" queue p95={fmt_opt(row['queue_wait_p95'])}"
                f" (n={row['queue_wait_count']})"
            )
    prog = report.get("progressive") or {}
    if prog.get("estimates_answered") or any(
        (prog.get("continuations") or {}).values()
    ):
        conts = prog["continuations"]
        ttfa = prog["time_to_first_answer"]
        tte = prog["time_to_exact"]
        lines.append("")
        lines.append(
            "progressive (docs/SERVING.md progressive runbook):"
        )
        lines.append(
            f"  estimates_answered={prog['estimates_answered']}"
            f"  continuations: enqueued={conts['enqueued']}"
            f" completed={conts['completed']}"
            f" cancelled={conts['cancelled']} shed={conts['shed']}"
        )
        lines.append(
            f"  time_to_first_answer p50={fmt_opt(ttfa['p50'])}"
            f" p95={fmt_opt(ttfa['p95'])} (n={ttfa['count']})"
            f"  time_to_exact p50={fmt_opt(tte['p50'])}"
            f" p95={fmt_opt(tte['p95'])} (n={tte['count']})"
        )
    appended = report.get("append") or {}
    if (
        appended.get("appends_served")
        or appended.get("plane_stores_written")
        or appended.get("refresh_recommended")
    ):
        frac = appended["marginal_lane_fraction"]
        lines.append("")
        lines.append("append (docs/SERVING.md append runbook):")
        lines.append(
            f"  appends_served={appended['appends_served']}"
            f"  plane_stores_written="
            f"{appended['plane_stores_written']}"
            f"  refresh_recommended="
            f"{appended['refresh_recommended']}"
        )
        lines.append(
            "  marginal-vs-full ratio"
            f" p50={fmt_opt(frac['p50'])}"
            f" max={fmt_opt(frac['max'])} (n={frac['count']};"
            " 1.000 = disclosed full-recompute fallback)"
            + (
                f"  max_drift_excess="
                f"{fmt_opt(appended['max_drift_excess'])}"
                if appended.get("max_drift_excess") is not None else ""
            )
        )
    per_worker = report.get("per_worker") or {}
    if per_worker:
        lines.append("")
        lines.append("per-worker (docs/SERVING.md multi-worker runbook):")
        for worker, row in per_worker.items():
            lines.append(
                f"  {worker}  done={row['done']} failed={row['failed']}"
                f" retried={row['retried']} requeued={row['requeued']}"
                f" takeovers={row['takeovers']}"
                f" refused_writes={row['refused_writes']}"
                f" steals={row.get('steals', 0)}"
                f" jobs_stolen={row.get('jobs_stolen', 0)}"
                f" jobs_lost_to_steal={row.get('jobs_lost_to_steal', 0)}"
                f" heartbeats={row.get('heartbeats', 0)}"
            )
    fleet = report.get("fleet") or {}
    live = fleet.get("live")
    if fleet.get("scale_signals") or (live and live.get("workers")):
        lines.append("")
        lines.append("fleet (docs/SERVING.md fleet runbook):")
        last = fleet.get("last_scale_signal")
        if last is not None:
            lines.append(
                f"  scale_signals={fleet.get('scale_signals', 0)}"
                f"  latest={last.get('recommendation')}"
                f" (workers={last.get('workers_seen')}"
                f" backlog={last.get('fleet_backlog')}"
                f" running={last.get('fleet_running')}"
                f" drain/s={fmt_opt(last.get('fleet_drain_rate_per_s'))}"
                f" est_drain={fmt_opt(last.get('est_drain_seconds'))}"
                f" slo_burn={last.get('slo_burn_active')})"
            )
        if live is not None:
            for worker, hb in (live.get("workers") or {}).items():
                lines.append(
                    f"  live {worker}  queue={hb.get('queue_depth')}"
                    f" running={hb.get('running')}"
                    f" drain/s={fmt_opt(hb.get('drain_rate_per_s'))}"
                    f" slo_burn={hb.get('slo_burn_active')}"
                    f" age={fmt_opt(hb.get('age_seconds'))}s"
                )
            if live.get("rejected"):
                lines.append(
                    f"  rejected_heartbeats={live['rejected']}"
                    " (torn/bit-flipped/stale — excluded from rows)"
                )
    lines.append("")
    lines.append(
        "retries: " + (
            " ".join(
                f"{k}={v}" for k, v in sorted(report["retries"].items())
            ) or "(none)"
        )
    )
    lines.append(f"wedges: {report['wedges']}")
    lines.append(
        "perf_drift: " + (
            " ".join(
                f"{k}={v}"
                for k, v in sorted(report["perf_drift"].items())
            ) or "(none)"
        )
    )
    if report["slo_breaches"]:
        for objective, buckets in sorted(report["slo_breaches"].items()):
            lines.append(
                f"slo_breach[{objective}]: " + " ".join(
                    f"{k}={v}" for k, v in sorted(buckets.items())
                )
            )
    else:
        lines.append("slo_breach: (none)")
    lines.append(
        f"integrity_violations: {report['integrity_violations']}"
    )
    lines.append(
        "preflight_inaccurate: " + (
            " ".join(
                f"{k}={v}"
                for k, v in sorted(report["preflight_inaccurate"].items())
            ) or "(none)"
        )
    )
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# bundle: a forensic capsule for one job


def env_fingerprint() -> Dict[str, Any]:
    """Where this bundle was cut: host/python/platform — stdlib only (a
    wedged backend cannot be asked for its device_kind, and this tool
    runs exactly then).  The job record's own ``result.backend`` carries
    the backend label when the job completed."""
    return {
        "hostname": socket.gethostname(),
        "platform": platform.platform(),
        "python": sys.version.split()[0],
        "created_at": round(time.time(), 3),
        "tool": "consensus_clustering_tpu_torch serve-admin bundle",
    }


def build_bundle(
    store_dir: str,
    events_path: Optional[str],
    job_id: str,
    out_path: str,
    metrics_text: Optional[str] = None,
) -> List[str]:
    """Write ``out_path`` (tar.gz) with one job's forensic capsule;
    returns the member names written.

    Members: ``record.json`` (the jobstore record, result included),
    ``events.jsonl`` (the job's lifecycle slice), ``spans.jsonl`` (its
    trace), ``trace.txt`` (the rendered tree), ``report.json`` (the
    whole-log summary for context), ``metrics.json`` (only when the
    caller fetched a live snapshot), ``env.json``.  The data matrix is
    DELIBERATELY absent — a bundle is for sharing, and the payload
    ``.npy`` is the part that must not travel.
    """
    members: List[Tuple[str, bytes]] = []

    record_path = os.path.join(store_dir, "jobs", f"{job_id}.json")
    try:
        with open(record_path, "rb") as f:
            members.append(("record.json", f.read()))
    except OSError:
        members.append((
            "record.json",
            json.dumps(
                {"job_id": job_id, "error": "no record in store"}
            ).encode(),
        ))
    if events_path and os.path.exists(events_path):
        events = load_events(events_path)
        lifecycle, spans = job_events(events, job_id)
        members.append((
            "events.jsonl",
            "".join(
                json.dumps(e, sort_keys=True) + "\n" for e in lifecycle
            ).encode(),
        ))
        members.append((
            "spans.jsonl",
            "".join(
                json.dumps(s, sort_keys=True) + "\n" for s in spans
            ).encode(),
        ))
        members.append((
            "trace.txt", (render_trace(events, job_id) + "\n").encode()
        ))
        members.append((
            "report.json",
            json.dumps(summarize(events), indent=1, sort_keys=True)
            .encode(),
        ))
    if metrics_text is not None:
        members.append(("metrics.json", metrics_text.encode()))
    members.append((
        "env.json",
        json.dumps(env_fingerprint(), indent=1, sort_keys=True).encode(),
    ))

    tmp = f"{out_path}.{os.getpid()}.tmp"
    try:
        with tarfile.open(tmp, "w:gz") as tar:
            for name, blob in members:
                info = tarfile.TarInfo(name=f"{job_id}/{name}")
                info.size = len(blob)
                info.mtime = int(time.time())
                tar.addfile(info, io.BytesIO(blob))
        os.replace(tmp, out_path)
    except BaseException:
        # Disk-full mid-write: the half-tar lives wherever --out
        # pointed, outside any store GC's reach — clean it here.
        try:
            os.remove(tmp)
        except OSError:
            pass
        raise
    return [f"{job_id}/{name}" for name, _ in members]
