"""Memory preflight: the byte models ``mode="auto"`` resolves against.

Copies of three functions of the reference package's
``serve/preflight.py`` (the rest of serving is ROADMAP item A10):

- :func:`estimate_job_bytes`: a streamed exact job's device footprint,
  whose leading term is the dense int32 state ``4·(nK+1)·N²`` bytes
  (at N = 10^5 and K = 2..20, 800 GB);
- :func:`estimate_estimator_bytes`: the sampled-pair estimator's, O(M)
  state plus per-block (h_block, N) scatters;
- :func:`resolve_memory_budget`: the budget in bytes, from an explicit
  value, else ``CCTPU_MEMORY_BUDGET``, else the device's own memory
  (``total_memory`` of a CUDA device; host RAM for the CPU).  Where the
  reference falls back to host RAM when the device query fails, a CUDA
  query that fails here raises: a card's budget is never host RAM.

Deliberately simple lower bounds with exact leading terms: if the
estimate alone exceeds the budget, the real run certainly does.
"""

from __future__ import annotations

import logging
import os
from typing import Any, Dict, Optional, Sequence

from consensus_clustering_tpu_torch.estimator.bounds import default_n_pairs

logger = logging.getLogger(__name__)

#: Extra state generations the checkpoint writer can pin at once (the
#: newest host copy, one queued, one serialising).
_CHECKPOINT_PIN_GENERATIONS = 2

ENV_BUDGET = "CCTPU_MEMORY_BUDGET"


def estimate_job_bytes(
    n: int,
    d: int,
    k_values: Sequence[int],
    dtype: str = "float32",
    h_block: int = 16,
    subsampling: float = 0.8,
    checkpoints: bool = True,
) -> Dict[str, Any]:
    """Estimated device footprint of one streamed exact job, in bytes:
    each term and ``total_bytes``.  Monotonic in N, |K| and h_block."""
    n = int(n)
    nk = len(tuple(k_values))
    k_max = max(int(k) for k in k_values)
    itemsize = 8 if dtype == "float64" else 4
    n_sub = max(1, int(round(n * float(subsampling))))

    state = 4 * (nk + 1) * n * n
    pin = 1 + (_CHECKPOINT_PIN_GENERATIONS if checkpoints else 0)
    workspace = 8 * n * n
    data = n * d * itemsize
    lanes = 2 * int(h_block) * n_sub * (d + k_max) * itemsize
    total = state * pin + workspace + data + lanes
    return {
        "state_bytes": int(state),
        "pinned_state_generations": int(pin),
        "workspace_bytes": int(workspace),
        "data_bytes": int(data),
        "lane_bytes": int(lanes),
        "total_bytes": int(total),
        "model": "dense int32 accumulators (exact) + f32 consensus "
        "workspace + data + clustering lanes; see serve/preflight.py",
    }


def estimate_estimator_bytes(
    n: int,
    d: int,
    k_values: Sequence[int],
    n_pairs: Optional[int] = None,
    dtype: str = "float32",
    h_block: int = 16,
    subsampling: float = 0.8,
    checkpoints: bool = True,
    accum_repr: str = "dense",
) -> Dict[str, Any]:
    """Estimated device footprint of the sampled-pair estimator for the
    same job: per-K pair counts ``4·(nK+1)·M`` (the only state), the pair
    index arrays, the per-block (h_block, N) label/sample scatters (packed:
    ``ceil(h_block/32)`` words a column), the per-block (h_block, M)
    gathers, data and clustering lanes.  Monotonic in N, M, |K| and
    h_block."""
    n = int(n)
    nk = len(tuple(k_values))
    k_max = max(int(k) for k in k_values)
    itemsize = 8 if dtype == "float64" else 4
    n_sub = max(1, int(round(n * float(subsampling))))
    m = int(n_pairs) if n_pairs else default_n_pairs(n)

    state = 4 * (nk + 1) * m
    pin = 1 + (_CHECKPOINT_PIN_GENERATIONS if checkpoints else 0)
    pairs = 2 * 4 * m
    if accum_repr == "packed":
        scatter = 2 * -(-int(h_block) // 32) * n * (4 + 4)
    else:
        scatter = 2 * int(h_block) * n * (4 + 4)
    pair_workspace = 12 * int(h_block) * m
    data = n * d * itemsize
    lanes = 2 * int(h_block) * n_sub * (d + k_max) * itemsize
    total = state * pin + pairs + scatter + pair_workspace + data + lanes
    return {
        "state_bytes": int(state),
        "pinned_state_generations": int(pin),
        "pair_bytes": int(pairs),
        "scatter_bytes": int(scatter),
        "pair_workspace_bytes": int(pair_workspace),
        "data_bytes": int(data),
        "lane_bytes": int(lanes),
        "n_pairs": int(m),
        "accum_repr": str(accum_repr),
        "total_bytes": int(total),
        "model": "O(M) pair-count state + per-block (h_block, N) "
        "scatters + data + clustering lanes; see serve/preflight.py",
    }


def resolve_memory_budget(
    explicit: Optional[int] = None, device=None
) -> Optional[int]:
    """The memory budget in bytes, or None when none can be determined.

    Precedence: ``explicit`` (<= 0: no budget), then the
    ``CCTPU_MEMORY_BUDGET`` environment variable (bytes; a non-integer is
    ignored with a warning), then the device's own memory: a CUDA
    device's ``total_memory`` (``device`` None means ``cuda``; a failed
    query raises), the CPU's physical RAM.
    """
    if explicit is not None:
        return int(explicit) if explicit > 0 else None
    env = os.environ.get(ENV_BUDGET)
    if env:
        try:
            v = int(env)
            return v if v > 0 else None
        except ValueError:
            logger.warning("ignoring non-integer %s=%r", ENV_BUDGET, env)
    import torch

    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        return int(torch.cuda.get_device_properties(dev).total_memory)
    try:
        return int(os.sysconf("SC_PHYS_PAGES")) * int(
            os.sysconf("SC_PAGE_SIZE"))
    except (ValueError, OSError, AttributeError):
        return None
