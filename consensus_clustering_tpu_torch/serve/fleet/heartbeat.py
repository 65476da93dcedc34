# Copied from consensus_clustering_tpu/serve/fleet/heartbeat.py.
"""Fleet heartbeats: crash-safe, digest-verified capacity adverts.

Each worker's lease-maintenance thread rewrites
``fleet/<worker_id>.json`` every sweep with its live capacity picture
(queue backlog in approximate pickup order, running set, drain rate,
warm executable buckets, SLO burn).  The file rides the jobstore's
atomic tmp-then-rename discipline, so a reader never observes a torn
write from a healthy writer — and an embedded sha256 digest over the
canonical payload catches the writes no rename can protect against
(disk-level bit flips, truncation, hand edits).  A heartbeat that
fails the digest, parses to the wrong shape, or is older than
``stale_after`` is REJECTED, not repaired: the steal planner and the
autoscale signal only ever act on heartbeats that verify, and with
none verifying the scheduler degrades to the proven solo pickup
(docs/SERVING.md "Fleet runbook" degrade table).

Stdlib-only: ``serve-admin report`` renders fleet rows from
:func:`read_fleet` under its no-jax ``-X importtime`` pin.
"""

from __future__ import annotations

import hashlib
import json
import os
import uuid
from typing import Any, Dict, Optional, Tuple

#: Bumped when the payload schema changes incompatibly; readers reject
#: versions they do not know rather than misread them.
HEARTBEAT_VERSION = 1


def heartbeat_path(fleet_dir: str, worker_id: str) -> str:
    """``fleet/<worker_id>.json`` — worker ids are restart-stable and
    unique per worker (the lease layer's contract), so one file per
    worker, rewritten in place, is the whole advertisement protocol."""
    safe = str(worker_id).replace(os.sep, "_")
    return os.path.join(fleet_dir, f"{safe}.json")


def heartbeat_digest(payload: Dict[str, Any]) -> str:
    """sha256 over the canonical JSON of everything but ``digest``."""
    body = {k: v for k, v in payload.items() if k != "digest"}
    canonical = json.dumps(body, sort_keys=True, default=float)
    return hashlib.sha256(canonical.encode()).hexdigest()


def write_heartbeat(fleet_dir: str, payload: Dict[str, Any]) -> str:
    """Atomically publish a worker's heartbeat; returns its path.

    The payload must carry ``worker_id`` and ``ts``; ``version`` and
    ``digest`` are stamped here.  Tmp-then-rename (the jobstore's
    discipline — the tmp name embeds ``.tmp`` so the store's stale-tmp
    sweep owns any crash-stranded half-write)."""
    os.makedirs(fleet_dir, exist_ok=True)
    payload = dict(payload)
    payload["version"] = HEARTBEAT_VERSION
    payload["digest"] = heartbeat_digest(payload)
    path = heartbeat_path(fleet_dir, payload["worker_id"])
    tmp = f"{path}.{uuid.uuid4().hex}.tmp"
    with open(tmp, "w") as f:
        json.dump(payload, f, sort_keys=True, default=float)
    os.replace(tmp, path)
    return path


def read_heartbeat(path: str) -> Optional[Dict[str, Any]]:
    """One verified heartbeat, or ``None`` when the file is absent,
    torn, the wrong shape/version, or fails its digest.  Rejection is
    deliberately indistinguishable from absence to callers: an
    unverifiable advert must never steer a steal."""
    try:
        with open(path) as f:
            payload = json.load(f)
    except (OSError, ValueError):
        return None
    if not isinstance(payload, dict):
        return None
    if payload.get("version") != HEARTBEAT_VERSION:
        return None
    if not isinstance(payload.get("worker_id"), str):
        return None
    digest = payload.get("digest")
    if not isinstance(digest, str):
        return None
    if digest != heartbeat_digest(payload):
        return None
    return payload


def read_fleet(
    fleet_dir: str,
    *,
    now: float,
    stale_after: float,
    skip_worker: Optional[str] = None,
) -> Tuple[Dict[str, Dict[str, Any]], int]:
    """Every VERIFIED, FRESH peer heartbeat, keyed by worker_id.

    Returns ``(peers, rejected)`` where ``rejected`` counts files that
    existed but failed verification (torn/bit-flipped/wrong version) or
    aged past ``stale_after`` — a dead worker's file must age out of
    steering steals long before the grace-windowed GC removes it.
    An absent or unlistable ``fleet/`` dir is simply an empty fleet."""
    peers: Dict[str, Dict[str, Any]] = {}
    rejected = 0
    try:
        names = sorted(os.listdir(fleet_dir))
    except OSError:
        return peers, rejected
    for name in names:
        if not name.endswith(".json") or ".tmp" in name:
            continue
        payload = read_heartbeat(os.path.join(fleet_dir, name))
        if payload is None:
            rejected += 1
            continue
        worker_id = payload["worker_id"]
        if skip_worker is not None and worker_id == skip_worker:
            continue
        ts = float(payload.get("ts") or 0.0)
        if now - ts > stale_after:
            rejected += 1
            continue
        peers[worker_id] = payload
    return peers, rejected


__all__ = [
    "HEARTBEAT_VERSION",
    "heartbeat_digest",
    "heartbeat_path",
    "read_fleet",
    "read_heartbeat",
    "write_heartbeat",
]
