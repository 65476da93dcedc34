# Copied from consensus_clustering_tpu/serve/sched/fusion.py.
"""Same-bucket job fusion: k concurrent jobs, one device program.

H-agnostic bucketing made same-bucket jobs COMMON: every job at
one (shape, K-range, dtype, clusterer, block size) shares a warm
executable whatever its H.  When several of them are runnable at once,
running them one-by-one pays k× the per-block dispatch overhead for
identical programs.  Fusion batches them instead: the streaming engine
compiles ``jit(vmap(step))`` over a leading job axis
(:meth:`~consensus_clustering_tpu_torch.parallel.streaming.StreamingSweep.
run_fused`) and streams k datasets through ONE device program per
block — amortizing dispatch exactly the way ``cluster_batch``
amortizes resamples.

THE PARITY GATE: a fused job's results, ``result_fingerprint`` and
checkpoint frames are bit-identical to its solo execution (the vmapped
lanes run the same integer-count arithmetic; tests/test_sched.py pins
it, including resume from fused-written frames).  Fusion is therefore
a pure throughput optimization — it can never change an answer — and
it DEGRADES, never blocks: any eligibility mismatch runs the job solo,
and any error inside a fused attempt falls every job in the batch back
to the solo path (which retries/resumes through the ordinary
machinery, from whatever checkpoints the fused attempt wrote).

Eligibility (:func:`fusion_key`): two jobs fuse iff their keys are
equal and non-None —

- same executable bucket (shape, K, dtype, clusterer, options, bins,
  subsampling, parity, resolved block size — everything the compiled
  program depends on),
- same ``n_iterations`` (the fused block loop is shared),
- ``mode == "exact"`` (the sampled-pair estimator keeps its own
  engine), and
- no adaptive early stop (per-job stop decisions would desync the
  shared loop),

while tenant, priority and seed are deliberately NOT in the key: the
whole point is that *different* users' same-shaped jobs ride together.
Jobs with identical (config, data) fingerprints never share a batch —
they would race one checkpoint ring — and jobs with a non-empty ring
run solo (resume is a solo-path feature by design).

Stdlib-only: the planning is pure bookkeeping; the device work lives
in the streaming engine and the executor.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional

#: Cap on jobs per fused device program.  The batch multiplies the
#: accumulator footprint (k × the solo state), so the ceiling exists
#: even when the queue could feed more.
MAX_FUSE_HARD_CAP = 16


def fusion_key(spec, n: int, d: int, h_block: int) -> Optional[str]:
    """The fusion-eligibility key for a job, or ``None`` when the job
    must run solo.  Equal keys ⇒ the jobs can share one fused program.
    """
    if getattr(spec, "mode", "exact") != "exact":
        return None
    if getattr(spec, "adaptive_tol", None) is not None:
        return None
    return json.dumps(
        {
            "bucket": spec.bucket(n, d, h_block),
            "h": int(spec.n_iterations),
        },
        sort_keys=True,
    )


def ring_is_empty(checkpoint_dir: str) -> bool:
    """True when a job's checkpoint ring holds no frames — the no-resume
    precondition for fusing it (a job with progress resumes solo)."""
    try:
        return not any(
            name.startswith("gen-") for name in os.listdir(checkpoint_dir)
        )
    except OSError:
        return True


def partition_batch(
    job_ids: List[str],
    fingerprints: Dict[str, Optional[str]],
    ring_empty: Dict[str, bool],
) -> Dict[str, List[str]]:
    """Split a candidate batch into the jobs that may fuse and the jobs
    that must run solo.

    - duplicate fingerprints: the FIRST job with a fingerprint fuses,
      its twins run solo (two writers on one ring would race; the solo
      twin late-dedups against the fused one's stored result anyway);
    - non-empty checkpoint ring: solo (resume fidelity outranks
      dispatch amortization).
    """
    fused: List[str] = []
    solo: List[str] = []
    seen: set = set()
    for job_id in job_ids:
        fp = fingerprints.get(job_id)
        if fp is None or fp in seen or not ring_empty.get(job_id, False):
            solo.append(job_id)
            continue
        seen.add(fp)
        fused.append(job_id)
    if len(fused) < 2:
        # A batch of one is not a batch: everything runs solo.
        solo = fused + solo
        fused = []
    return {"fused": fused, "solo": solo}


__all__ = [
    "MAX_FUSE_HARD_CAP",
    "fusion_key",
    "partition_batch",
    "ring_is_empty",
]
