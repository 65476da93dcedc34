# Copied from consensus_clustering_tpu/serve/fleet/__init__.py.
"""Capacity-aware fleet layer: heartbeats, work stealing, autoscale.

PRs 10/12 made N serve workers over one shared store *correct* (fenced
leases) and one worker *smart* (fair-share + same-bucket fusion); this
package is the layer between them — what makes N workers *fast*
(docs/SERVING.md "Fleet runbook"):

- :mod:`.heartbeat` — each worker's lease-maintenance thread publishes
  a crash-safe, digest-verified ``fleet/<worker_id>.json`` capacity
  advertisement (backlog, running set, drain rate, warm executable
  buckets, SLO burn) through the jobstore's atomic tmp-then-rename
  discipline; peers and ``serve-admin`` read it with no live endpoint;
- :mod:`.steal`     — the work-stealing planner: an idle worker steals
  *same-bucket sets, not single jobs* from the most backlogged peer's
  advertised tail, preferring buckets the stealer has warm, so a
  stolen set still rides fused device programs.  A steal is
  just a lease claim (``LeaseManager.claim_steal``) — zero new
  ownership semantics, and the fence refuses the victim's late writes
  exactly as it refuses a zombie's;
- :mod:`.signal`    — the measured autoscale recommendation
  (``scale_out`` | ``scale_in`` | ``hold``) derived from fleet-wide
  queue drain rate + multi-window SLO burn, disclosed with its basis
  as a ``fleet_scale_signal`` event, a ``/metrics`` section, and prom
  gauges.

Everything degrades: an absent, torn, bit-flipped, or stale ``fleet/``
directory is REJECTED at read (the digest + staleness gate) and the
scheduler falls back to the proven solo pickup — the fleet layer can
make N workers faster, never less correct.

Lazy exports (PEP 562, the serve package's own pattern): every module
here is stdlib-only at import time, and the lazy indirection keeps
import costs off the ``serve-admin``/``lint`` no-jax paths all the
same.
"""

import importlib

_EXPORTS = {
    "HEARTBEAT_VERSION": "consensus_clustering_tpu_torch.serve.fleet.heartbeat",
    "heartbeat_path": "consensus_clustering_tpu_torch.serve.fleet.heartbeat",
    "heartbeat_digest": "consensus_clustering_tpu_torch.serve.fleet.heartbeat",
    "read_fleet": "consensus_clustering_tpu_torch.serve.fleet.heartbeat",
    "read_heartbeat": "consensus_clustering_tpu_torch.serve.fleet.heartbeat",
    "write_heartbeat": "consensus_clustering_tpu_torch.serve.fleet.heartbeat",
    "plan_steal": "consensus_clustering_tpu_torch.serve.fleet.steal",
    "scale_signal": "consensus_clustering_tpu_torch.serve.fleet.signal",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    module = _EXPORTS.get(name)
    if module is None:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}"
        )
    return getattr(importlib.import_module(module), name)


def __dir__():
    return sorted(set(globals()) | set(_EXPORTS))
