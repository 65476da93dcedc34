"""Published peaks of one NVIDIA H100 and the least time a kernel's work
can take on it: the yardstick of the roofline metrics.

A frozen copy of the arithmetic the port's smoke script
(``chip_smoke.py``) held its kernels to.  The peaks are the SXM part's
data-sheet rates at the full 700 W: HBM at 3.35 TB/s, float32 outside the
tensor cores at 67 TFLOP/s, and the POPC rate of 16 results per clock per
SM (CUDA programming guide, compute capability 9.0) on 132 SMs at the
1.98 GHz boost clock.  A card set below 700 W (``nvidia-smi
--query-gpu=power.limit``) reaches less.

The work is what a call's inputs need, counted from their shapes, whatever
the kernel behind the call chooses to do: each input byte read once, each
output byte written once.
"""

from __future__ import annotations

import math
from typing import Tuple

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
POPC_PER_S = 16 * 132 * 1.98e9


def bound_ms(n_bytes: float, n_ops: float,
             ops_per_s: float = F32_OPS_PER_S) -> Tuple[float, str]:
    """(least milliseconds, what bounds them: "bytes" or "operations")."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / ops_per_s * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def lloyd_step_work(resamples: int, rows: int, d: int, lanes: int,
                    k: int) -> Tuple[float, float]:
    """(bytes, float32 operations) of one Lloyd step (kernel B2) over
    ``lanes`` KMeans lanes of ``rows`` rows and d features with ``k``
    clusters, reading ``resamples`` distinct subsamples: the distances
    (2d multiply-adds and 3 more a centre), the argmin and the sums and
    counts (3d a row); the rows, centres and lane map in, the sums, counts
    and far points out."""
    n_bytes = 4 * (resamples * rows * d + lanes * k * d + lanes
                   + lanes * k * (d + 2))
    n_ops = lanes * rows * (2 * d * k + 3 * k + 3 * d)
    return n_bytes, n_ops


def lloyd_step_bound_ms(resamples: int, rows: int, d: int, lanes: int,
                        k: int) -> float:
    return bound_ms(*lloyd_step_work(resamples, rows, d, lanes, k))[0]


def popcount_work(words: int, rows: int, cols: int) -> Tuple[float, float]:
    """(bytes, POPC operations) of one popcount count tile (kernel B3):
    (words, rows) and (words, cols) int32 words in, (rows, cols) int32
    counts out, one POPC per word of each (row, column) pair."""
    return 4 * (words * (rows + cols) + rows * cols), words * rows * cols


def popcount_bound_ms(words: int, rows: int, cols: int) -> float:
    return bound_ms(*popcount_work(words, rows, cols), POPC_PER_S)[0]


def lloyd_resamples_read(lanes: int, resamples: int, n_init: int) -> int:
    """The fewest distinct subsamples ``lanes`` lanes can read when each
    subsample carries ``n_init`` restarts: a call's lane map is on the
    device, so the bound takes the least the inputs need."""
    return max(1, min(resamples, math.ceil(lanes / max(1, n_init))))
