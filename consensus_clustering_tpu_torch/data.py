"""Datasets: the bundled corr.csv, a CSV reader and a numpy-only
``make_blobs``.

``data/corr.csv`` is a byte copy of the reference package's file (see
NOTICE at the repository root for its provenance).  Neither function needs
pandas or scikit-learn.
"""

from __future__ import annotations

import csv
import os

import numpy as np

_DATA_DIR = os.path.join(os.path.dirname(__file__), "data")


def _yeo_johnson_standardized(x: np.ndarray) -> np.ndarray:
    """Per-column Yeo-Johnson at the maximum-likelihood lambda, then
    zero-mean unit-variance (ddof 0) — what ``PowerTransformer()`` does."""
    from scipy import stats

    out = np.empty_like(x)
    for j in range(x.shape[1]):
        out[:, j], _ = stats.yeojohnson(x[:, j])
    mean = out.mean(axis=0)
    std = out.std(axis=0)
    std = np.where(std == 0.0, 1.0, std)
    return (out - mean) / std


def read_csv(path: str) -> np.ndarray:
    """The float64 values of a CSV file with a header row and an index
    column: ``pandas.read_csv(path, index_col=0).values`` without pandas.

    Python's ``float`` rounds each decimal correctly, where pandas' C
    parser can land one float64 ulp off; cast to float32, as the command
    line does, the two agree on corr.csv bit for bit.
    """
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    return np.asarray([[float(v) for v in row[1:]] for row in rows[1:]])


def load_corr(transform: bool = False) -> np.ndarray:
    """The bundled 29x29 correlation dataset as (29, 29) float32.

    ``transform=True`` applies the reference notebook's preprocessing:
    Yeo-Johnson per column, then standardisation.
    """
    x = read_csv(os.path.join(_DATA_DIR, "corr.csv"))
    if transform:
        x = _yeo_johnson_standardized(x)
    return x.astype(np.float32)


def make_blobs(
    n_samples: int = 100,
    n_features: int = 2,
    centers: int = 3,
    cluster_std: float = 1.0,
    center_box=(-10.0, 10.0),
    shuffle: bool = True,
    random_state: int = 0,
):
    """Isotropic Gaussian blobs, equal to ``sklearn.datasets.make_blobs``
    with an integer ``n_samples``, ``centers`` and ``cluster_std``.

    The draws follow scikit-learn's order on one ``np.random.RandomState``:
    the centres (uniform in ``center_box``), each blob's normals in turn,
    then one in-place shuffle of the row order.  Returns (X float64, y).
    """
    rs = np.random.RandomState(random_state)
    centre_xy = rs.uniform(
        center_box[0], center_box[1], size=(centers, n_features)
    )
    per_centre = [n_samples // centers] * centers
    for i in range(n_samples % centers):
        per_centre[i] += 1
    x = np.empty((n_samples, n_features), dtype=np.float64)
    y = np.empty((n_samples,), dtype=int)
    start = 0
    for i, n in enumerate(per_centre):
        x[start:start + n] = rs.normal(
            loc=centre_xy[i], scale=cluster_std, size=(n, n_features)
        )
        y[start:start + n] = i
        start += n
    if shuffle:
        order = np.arange(n_samples)
        rs.shuffle(order)
        x, y = x[order], y[order]
    return x, y
