# Copied from consensus_clustering_tpu/serve/sched/__init__.py.
"""Fair-share scheduling subsystem: weighted queues, same-bucket job
fusion, and streamed partial results (docs/SERVING.md "Fair-share &
fusion runbook").

- :mod:`.fairshare` — deficit-round-robin weighted-fair queueing over
  tenant × priority lanes, with a starvation clock bounding every
  lane's wait;
- :mod:`.fusion`    — eligibility + planning for fusing k same-bucket
  jobs into ONE device program via a leading batch axis on the warm
  executable (bit-identical to solo execution — the parity gate;
  degrades to solo on any mismatch, never blocks);
- :mod:`.stream`    — the SSE event bus behind ``GET
  /jobs/<id>/events`` (per-block ``h_block_complete`` + the PAC
  trajectory streamed live) and the client-cancel semantics
  (``JobCancelled`` — a terminal state that releases leases and
  clears rings like ``done``).

Lazy exports (PEP 562, the serve package's own pattern): every module
here is stdlib-only, but the lazy indirection keeps import costs off
the ``serve-admin``/``lint`` no-jax paths all the same.
"""

import importlib

_EXPORTS = {
    "DEFAULT_PRIORITY_WEIGHTS":
        "consensus_clustering_tpu_torch.serve.sched.fairshare",
    "FairShareQueue": "consensus_clustering_tpu_torch.serve.sched.fairshare",
    "lane_name": "consensus_clustering_tpu_torch.serve.sched.fairshare",
    "parse_priority_weights":
        "consensus_clustering_tpu_torch.serve.sched.fairshare",
    "parse_tenant_weights":
        "consensus_clustering_tpu_torch.serve.sched.fairshare",
    "MAX_FUSE_HARD_CAP": "consensus_clustering_tpu_torch.serve.sched.fusion",
    "fusion_key": "consensus_clustering_tpu_torch.serve.sched.fusion",
    "partition_batch": "consensus_clustering_tpu_torch.serve.sched.fusion",
    "ring_is_empty": "consensus_clustering_tpu_torch.serve.sched.fusion",
    "JobCancelled": "consensus_clustering_tpu_torch.serve.sched.stream",
    "JobEventBus": "consensus_clustering_tpu_torch.serve.sched.stream",
    "sse_event": "consensus_clustering_tpu_torch.serve.sched.stream",
    "sse_keepalive": "consensus_clustering_tpu_torch.serve.sched.stream",
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
