"""The port's numpy-only datasets against scikit-learn and pandas.

``make_blobs`` must equal ``sklearn.datasets.make_blobs`` array for array.
``load_corr(transform=True)`` runs Yeo-Johnson through ``scipy.stats``
where the reference runs ``PowerTransformer``; the largest difference
measured on corr.csv is 4.8e-7 (one f32 ulp near 4), held here to 1e-5.
"""

import numpy as np
import pytest
from sklearn.datasets import make_blobs as sk_make_blobs

from consensus_clustering_tpu.data import load_corr as jax_load_corr
from consensus_clustering_tpu_torch.data import load_corr, make_blobs


@pytest.mark.parametrize(
    "kwargs",
    [dict(n_samples=5000, n_features=50, centers=8, cluster_std=3.0,
          random_state=0),
     dict(n_samples=121, n_features=5, centers=3, cluster_std=0.5,
          random_state=7),
     dict(n_samples=10, n_features=2, centers=4, cluster_std=1.0,
          random_state=3, shuffle=False)],
)
def test_make_blobs_equals_sklearn(kwargs):
    ref_x, ref_y = sk_make_blobs(**kwargs)
    x, y = make_blobs(**kwargs)
    np.testing.assert_array_equal(x, ref_x)
    np.testing.assert_array_equal(y, ref_y)


def test_load_corr_raw_equals_reference():
    x = load_corr()
    assert x.shape == (29, 29) and x.dtype == np.float32
    np.testing.assert_array_equal(x, jax_load_corr())


def test_load_corr_transform_within_tolerance():
    x = load_corr(transform=True)
    ref = jax_load_corr(transform=True)
    assert x.dtype == np.float32
    np.testing.assert_allclose(x, ref, rtol=0, atol=1e-5)
    np.testing.assert_allclose(x.mean(axis=0), 0.0, atol=1e-5)
    np.testing.assert_allclose(x.std(axis=0), 1.0, atol=1e-5)
