# Copied from consensus_clustering_tpu/serve/fleet/steal.py.
"""The work-stealing planner: same-bucket SETS, from the victim's tail.

Pure bookkeeping over verified heartbeats — no disk, no locks, no
scheduler state — so the policy is unit-testable in isolation and the
scheduler's execution step (claim → load payload → enqueue) stays a
mechanical walk of the returned plan.

Three rules carry the whole design (docs/SERVING.md "Fleet runbook"):

- **Sets, not single jobs.**  fusion batches same-bucket jobs
  into one device program; stealing one job at a time would shred
  exactly the batches fusion feeds on.  The planner groups the
  victim's advertised backlog by ``(bucket, fuse_key)`` and takes one
  whole group (capped at ``max_jobs``), so a stolen set arrives
  fusable on the thief.
- **From the tail, warm first.**  The victim drains its queue from the
  head, so the planner skips the first ``head_skip`` advertised
  entries — the jobs the victim will pick up before it even learns it
  was robbed — and steals from the END of the chosen group.  Among
  eligible groups it prefers a bucket the thief already has a warm
  executable for (the steal then skips compilation entirely), then
  the largest group.
- **Advertised state only.**  The backlog snapshot in a heartbeat is
  approximate by construction (the victim kept running while it was
  in flight); every claim the scheduler later makes re-reads the
  record and the lease, so a stale advert costs a skipped claim,
  never a double execution.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Set


def plan_steal(
    peers: Dict[str, Dict[str, Any]],
    *,
    max_jobs: int,
    head_skip: int = 2,
    min_peer_backlog: int = 1,
    warm_buckets: Optional[Set[str]] = None,
    exclude: Optional[Set[str]] = None,
) -> Optional[Dict[str, Any]]:
    """One steal plan, or ``None`` when no peer is worth robbing.

    Returns ``{"victim", "job_ids", "bucket", "fuse_key", "warm",
    "peer_backlog"}``; ``job_ids`` are at most ``max_jobs`` ids of one
    ``(bucket, fuse_key)`` group, in the victim's advertised pickup
    order (the scheduler claims them tail-first is already encoded:
    they come from the group's END).  ``exclude`` drops ids the caller
    already tracks (its own jobs, a set it just stole)."""
    if max_jobs < 1:
        return None
    warm = warm_buckets or set()
    excluded = exclude or set()
    best: Optional[Dict[str, Any]] = None
    # Most backlogged peer first: relieving the worst hot spot is both
    # the throughput move and the autoscale signal's best friend.
    ordered = sorted(
        peers.values(),
        key=lambda hb: -int(hb.get("queue_depth") or 0),
    )
    for hb in ordered:
        backlog = hb.get("backlog")
        victim = hb.get("worker_id")
        if not isinstance(backlog, list) or not victim:
            continue
        if int(hb.get("queue_depth") or 0) < min_peer_backlog:
            continue
        running = set(hb.get("running") or ())
        tail = backlog[max(0, int(head_skip)):]
        groups: Dict[tuple, List[Dict[str, Any]]] = {}
        for entry in tail:
            if not isinstance(entry, dict):
                continue
            job_id = entry.get("job_id")
            if (
                not isinstance(job_id, str)
                or job_id in running
                or job_id in excluded
            ):
                continue
            key = (entry.get("bucket"), entry.get("fuse_key"))
            groups.setdefault(key, []).append(entry)
        if not groups:
            continue

        def rank(item):
            (bucket, _fuse_key), entries = item
            return (bucket in warm, len(entries))

        (bucket, fuse_key), entries = max(groups.items(), key=rank)
        job_ids = [e["job_id"] for e in entries[-int(max_jobs):]]
        candidate = {
            "victim": victim,
            "job_ids": job_ids,
            "bucket": bucket,
            "fuse_key": fuse_key,
            "warm": bucket in warm,
            "peer_backlog": int(hb.get("queue_depth") or 0),
        }
        if best is None or (
            (candidate["warm"], len(candidate["job_ids"]))
            > (best["warm"], len(best["job_ids"]))
        ):
            best = candidate
        if best["warm"] and len(best["job_ids"]) >= max_jobs:
            break  # cannot do better than a full warm set
    return best


__all__ = ["plan_steal"]
