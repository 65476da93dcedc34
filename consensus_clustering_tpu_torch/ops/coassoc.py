"""Co-association (co-clustering) counts Mij.

``Mij[i, j]`` counts the resamples in which i and j got the same label.  Per
chunk of B resamples the labels scatter into a (B * k_max, N) one-hot, and
one GEMM ``Mij += C^T C`` adds the chunk's counts: the stacking sums over
both the resample and the label axis, which is ``sum_h C_h^T C_h``.
"""

from __future__ import annotations

from typing import Optional

import torch


def _one_hot_chunk(
    labels: torch.Tensor, indices: torch.Tensor, k_max: int, n_cols: int
) -> torch.Tensor:
    """(B * k_max, n_cols) f32 one-hot with C[b*k_max + label, index] = 1.

    Entries with a label outside [0, k_max) or an index outside
    [0, n_cols) — the padding of partial resample rows — are dropped.
    """
    batch = labels.shape[0]
    valid = (
        (labels >= 0) & (labels < k_max) & (indices >= 0) & (indices < n_cols)
    )
    base = torch.arange(batch, device=labels.device)[:, None] * k_max
    rows = (base + labels.to(torch.int64))[valid]
    c = torch.zeros(
        (batch * k_max, n_cols), dtype=torch.float32, device=labels.device
    )
    c[rows, indices[valid].to(torch.int64)] = 1.0
    return c


def coassociation_counts(
    labels: torch.Tensor,
    indices: torch.Tensor,
    n_samples: int,
    k_max: int,
    chunk_size: int = 8,
    *,
    n_cols: Optional[int] = None,
    row_start: Optional[int] = None,
    n_rows: Optional[int] = None,
) -> torch.Tensor:
    """(N, N) int32 ``Mij`` from (H, n_sub) labels and subsample indices.

    The one-hots are f32 and the GEMMs accumulate into an f32 ``Mij``: 0/1
    products and integer partial sums below 2^24 are exact in f32, so the
    counts equal the serial reference bit for bit.  (bf16 operands would
    give a bf16 product, which rounds integers above 256.)

    ``n_cols`` is the one-hot width (default N: a mesh's row-padded width,
    whose columns >= N stay zero); ``row_start``/``n_rows`` select the
    ``[row_start, row_start + n_rows)`` row block of the result, a 'n'
    shard's.
    """
    if n_cols is None:
        n_cols = n_samples
    if (row_start is None) != (n_rows is None):
        raise ValueError("row_start and n_rows must be passed together")
    n_iterations = labels.shape[0]
    chunk = max(1, min(chunk_size, n_iterations))
    out_rows = n_cols if row_start is None else n_rows
    mij = torch.zeros(
        (out_rows, n_cols), dtype=torch.float32, device=labels.device
    )
    for start in range(0, n_iterations, chunk):
        c = _one_hot_chunk(
            labels[start:start + chunk], indices[start:start + chunk],
            k_max, n_cols,
        )
        left = c if row_start is None else c[:, row_start:row_start + n_rows]
        mij.addmm_(left.T, c)
    return mij.to(torch.int32)
