"""Isotropic Gaussian blobs in NumPy: scikit-learn's ``make_blobs`` for an
integer ``n_samples``, ``centers`` and ``cluster_std``.

The draws follow scikit-learn's order on one ``np.random.RandomState``: the
centres (uniform in ``center_box``), each blob's normals in turn, then one
in-place shuffle of the rows.  The machine with the card has no
scikit-learn, so the benchmark makes its data with this copy.
"""

from __future__ import annotations

import numpy as np


def make_blobs(n_samples: int, n_features: int, centers: int,
               cluster_std: float, random_state: int,
               center_box=(-10.0, 10.0)):
    """(X float64 (n_samples, n_features), y int (n_samples,))."""
    rs = np.random.RandomState(random_state)
    centre_xy = rs.uniform(center_box[0], center_box[1],
                           size=(centers, n_features))
    sizes = [n_samples // centers] * centers
    for i in range(n_samples % centers):
        sizes[i] += 1
    x = np.empty((n_samples, n_features), dtype=np.float64)
    y = np.empty((n_samples,), dtype=int)
    start = 0
    for i, size in enumerate(sizes):
        x[start:start + size] = rs.normal(loc=centre_xy[i], scale=cluster_std,
                                          size=(size, n_features))
        y[start:start + size] = i
        start += size
    order = np.arange(n_samples)
    rs.shuffle(order)
    return x[order], y[order]
