"""Resampling plan and the co-sampling count matrix Iij.

Resample ``i`` is the first ``n_sub`` entries of a permutation drawn from
``fold_in(key, h_start + i)``, so the plan is a pure function of the key and
each row depends only on its global resample index — the same plan, bit for
bit, as the reference package's ``ops/resample.py`` (see :mod:`..rng`).
"""

from __future__ import annotations

from typing import Optional

import torch

from consensus_clustering_tpu_torch import rng
from consensus_clustering_tpu_torch.config import subsample_size

__all__ = [
    "subsample_size", "resample_indices", "indicator_matrix",
    "cosample_counts",
]


def resample_indices(
    key: torch.Tensor,
    n_samples: int,
    n_iterations: int,
    n_sub: int,
    h_start: int = 0,
) -> torch.Tensor:
    """The (H, n_sub) int64 no-replacement subsample plan on ``key``'s device.

    Row ``i`` is global resample ``h_start + i`` (uint32 wrap-around, as the
    reference folds uint32 data).
    """
    if not 0 < n_sub <= n_samples:
        raise ValueError(
            f"subsample size {n_sub} must be in (0, {n_samples}]"
        )
    h = torch.arange(n_iterations, dtype=torch.int64, device=key.device)
    keys = rng.fold_in(key, h + h_start)
    return rng.permutation(keys, n_samples)[:, :n_sub].contiguous()


def indicator_matrix(indices: torch.Tensor, n_samples: int,
                     n_cols: Optional[int] = None) -> torch.Tensor:
    """(H, n_cols) f32 0/1 indicator R with R[h, indices[h, :]] = 1
    (``n_cols`` default N).

    Negative (padding) indices and indices >= N are dropped.
    """
    h = indices.shape[0]
    n_cols = n_samples if n_cols is None else n_cols
    r = torch.zeros((h, n_cols), dtype=torch.float32, device=indices.device)
    rows = torch.arange(h, device=indices.device)[:, None].expand_as(indices)
    valid = (indices >= 0) & (indices < n_samples)
    r[rows[valid], indices[valid]] = 1
    return r


def cosample_counts(
    indices: torch.Tensor,
    n_samples: int,
    *,
    n_cols: Optional[int] = None,
    row_start: Optional[int] = None,
    n_rows: Optional[int] = None,
) -> torch.Tensor:
    """``Iij = R^T R``: (N, N) int32 counts of resamples holding both i, j.

    One f32 GEMM of 0/1 operands: every partial sum is an integer below
    2^24, so the f32 result is exact.  (A bf16 product would return bf16,
    which rounds integers above 256.)  ``n_cols``, ``row_start`` and
    ``n_rows`` select a row block of the padded matrix, as
    :func:`..ops.coassoc.coassociation_counts`.
    """
    if (row_start is None) != (n_rows is None):
        raise ValueError("row_start and n_rows must be passed together")
    r = indicator_matrix(indices, n_samples, n_cols)
    left = r if row_start is None else r[:, row_start:row_start + n_rows]
    return (left.T @ r).to(torch.int32)
