# Copied from consensus_clustering_tpu/serve/sched/progressive.py.
"""Progressive-precision serving: estimate now, exact in the background.

The product shape PRs 11-13 built the parts for, composed
(docs/SERVING.md "Progressive serving runbook").  A ``mode=progressive``
job is a two-phase contract:

1. **Answer phase** — the job itself runs the O(M) sampled-pair
   estimator (admitted, priced and executed exactly like
   ``mode=estimate``): the client gets PAC for every K with its
   disclosed DKW band at estimate latency, streamed over the SSE
   channel as blocks complete (``k_batch_complete`` frames carry the
   band fields — :func:`band_fields`).
2. **Refinement phase** — on estimate completion the scheduler
   enqueues a LOW-priority continuation job (:func:`plan_continuation`)
   that recomputes the chosen K's curve exactly via the tiled
   refinement path (``estimator/tiled.py``).  It rides the ordinary
   fair-share queue — same tenant lane as the parent, ``priority=low``
   — so it runs only when the weighted scheduler has capacity to spare,
   and it inherits every serving guarantee for free: lease/takeover
   survival, SLO and drift accounting, shed policy, cancel.

The upgrade is **disclosed, never swapped**: the continuation is its
own job with its own record, its own ``result_fingerprint`` lineage
(semantic ``mode="refine"`` — distinct by construction from both the
parent's ``mode="estimate"`` fingerprint and a from-scratch exact
one), and the parent's SSE channel announces it as
``continuation_enqueued`` then ``result_upgraded`` frames.  A client
that watched the CDF converge far enough can hang up early
(``?cancel_on_disconnect=1``) or POST cancel on the PARENT id — the
scheduler forwards the cancel to a still-pending continuation and the
fair-share slot is refunded, so abandoned refinements never burn
capacity.

This module is deliberately **stdlib + estimator.bounds only** (no jax
import): the scheduler calls it on the submission/completion path,
where an accidental engine import would stall admission behind a
device runtime.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

from consensus_clustering_tpu_torch.estimator.bounds import (
    DEFAULT_DELTA,
    default_n_pairs,
    dkw_epsilon,
    pac_error_bound,
)


def plan_continuation(
    parent_spec, result: Dict[str, Any], parent_job_id: str
):
    """The continuation :class:`~consensus_clustering_tpu_torch.serve.
    executor.JobSpec` for a completed progressive parent.

    Derived entirely from the parent spec plus the estimate result —
    deterministic, so two identical progressive parents plan identical
    continuations, whose identical fingerprints dedup to ONE refined
    result (the jobstore's first-writer-wins contract):

    - ``mode="refine"`` — the scheduler-only tiled-refinement mode
      (in neither ``ESTIMATOR_MODES`` nor ``SERVING_MODES``, so it is
      unreachable over HTTP by construction).
    - ``k_values=(best_k,)`` — exactness is bought for the CHOSEN K
      only; re-running the whole sweep exactly would be the O(N²·|K|)
      cost the estimator exists to avoid.
    - ``n_iterations=h_effective`` — the resamples the estimate
      ACTUALLY ran: the shared key-folding derives identical draws and
      labels from (seed, global resample index, k), so the refined
      curve is the exact statistic over the very resamples the
      estimate sampled pairs from — bit-identical to a dense sweep of
      the same (seed, H, K) at any tiling.
    - ``priority="low"``, parent's tenant kept — the QoS contract:
      refinement rides the parent tenant's fair-share lane at the
      lowest weight, consuming only idle capacity.
    - ``n_pairs=None``, ``adaptive_tol=None``, ``accum_repr="dense"``
      — estimator/adaptive/packed knobs are meaningless to the host
      tile loop; clearing them keeps the continuation fingerprint
      canonical.
    - ``refine_parent=parent_job_id`` — threads the parent id to the
      scheduler's submit path, which persists the linkage on the job
      RECORDS (``continuation_of`` / ``continuation_job_id``); the
      spec field itself never enters fingerprint, payload, or bucket.
    """
    return dataclasses.replace(
        parent_spec,
        mode="refine",
        k_values=(int(result["best_k"]),),
        n_iterations=int(result["h_effective"]),
        n_pairs=None,
        adaptive_tol=None,
        accum_repr="dense",
        priority="low",
        refine_parent=str(parent_job_id),
    )


def band_fields(
    n: int, n_pairs, parity_zeros: bool = True
) -> Dict[str, Any]:
    """The DKW band block progressive/estimate SSE progress frames
    carry (`k_batch_complete`), so a client can watch convergence
    without waiting for the terminal record: ``pac_error_bound`` (the
    two-sided band on any CDF difference, PAC included),
    ``cdf_epsilon`` (the one-curve DKW ε), ``delta`` (the confidence
    parameter), and the resolved pair count.  Pure arithmetic over
    ``estimator/bounds.py`` — the same numbers the terminal result's
    ``estimator`` block disclosed already; this puts them on the live
    stream."""
    m = int(n_pairs) if n_pairs else default_n_pairs(int(n))
    return {
        "n_pairs": m,
        "pac_error_bound": float(
            pac_error_bound(m, int(n), bool(parity_zeros))
        ),
        "cdf_epsilon": float(dkw_epsilon(m)),
        "delta": float(DEFAULT_DELTA),
    }
