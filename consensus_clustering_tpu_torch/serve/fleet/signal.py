# Copied from consensus_clustering_tpu/serve/fleet/signal.py.
"""The measured autoscale signal: drain arithmetic, not vibes.

One pure function over the fleet's verified heartbeats.  Both inputs
are quantities the serving stack already measures — the live queue
drain rate behind the dynamic Retry-After basis, and the multi-window
SLO burn ``obs/slo.py`` maintains — so the recommendation is EVIDENCE
with a disclosed basis dict, exposed three ways (a
``fleet_scale_signal`` event on every recommendation change, the
``/metrics`` ``fleet`` section, prom gauges) and never acted on by the
service itself: scaling is the operator's (or their autoscaler's)
move, this is the hook (docs/SERVING.md "Fleet runbook").

Semantics:

- ``scale_out`` — the fleet cannot drain its backlog inside
  ``target_drain_seconds`` at the measured rate (or has backlog with
  no measurable drain at all, or is burning SLO error budget while
  backlogged): more workers would convert directly into drain rate,
  because the steal planner spreads one store's backlog to whoever
  shows up.
- ``scale_in``  — more than one worker, zero backlog, zero running
  jobs: capacity is provably idle.
- ``hold``      — everything else, including the single-worker idle
  case (this layer never recommends scaling below one worker) and a
  fleet that is busy but keeping up.
"""

from __future__ import annotations

from typing import Any, Dict


def scale_signal(
    heartbeats: Dict[str, Dict[str, Any]],
    *,
    target_drain_seconds: float = 60.0,
) -> Dict[str, Any]:
    """``{"recommendation", "basis"}`` over verified heartbeats
    (the caller's own included — the signal describes the FLEET).

    The basis dict is the whole computation, disclosed: worker count,
    summed backlog/running/drain rate, the estimated seconds to drain,
    active SLO burn pairs, and the target the estimate was judged
    against."""
    workers = len(heartbeats)
    backlog = sum(
        int(hb.get("queue_depth") or 0) for hb in heartbeats.values()
    )
    running = sum(
        len(hb.get("running") or ()) for hb in heartbeats.values()
    )
    rates = [
        float(hb["drain_rate_per_s"])
        for hb in heartbeats.values()
        if hb.get("drain_rate_per_s")
    ]
    rate = sum(rates) if rates else None
    est_drain = (
        backlog / rate if rate else None
    )
    slo_burn_active = sum(
        int(hb.get("slo_burn_active") or 0) for hb in heartbeats.values()
    )
    basis: Dict[str, Any] = {
        "workers_seen": workers,
        "fleet_backlog": backlog,
        "fleet_running": running,
        "fleet_drain_rate_per_s": (
            round(rate, 4) if rate is not None else None
        ),
        "est_drain_seconds": (
            round(est_drain, 2) if est_drain is not None else None
        ),
        "slo_burn_active": slo_burn_active,
        "target_drain_seconds": float(target_drain_seconds),
    }
    if workers == 0:
        recommendation = "hold"
    elif backlog > 0 and (
        (est_drain is not None and est_drain > target_drain_seconds)
        or est_drain is None  # backlog with no measured drain at all
        or slo_burn_active > 0
    ):
        recommendation = "scale_out"
    elif workers > 1 and backlog == 0 and running == 0:
        recommendation = "scale_in"
    else:
        recommendation = "hold"
    return {"recommendation": recommendation, "basis": basis}


__all__ = ["scale_signal"]
