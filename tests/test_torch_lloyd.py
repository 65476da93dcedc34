"""The port's Lloyd step and KMeans against the reference package's.

- Lloyd step: the port's plain version against the reference Pallas kernel
  in interpret mode.  Counts and far-point indices exact; sums to rtol
  1e-5, and exact on data quantised to multiples of 1/8, where every sum is
  representable.
- KMeans in float64 from injected init centroids: labels identical.  The
  reference's float64 path needs ``JAX_ENABLE_X64`` before JAX starts, so
  it runs in a subprocess (as tests/test_parity.py does for its GMM).
- KMeans in float32 on the same keys: label agreement >= 99% and ARI >=
  0.99 on well-separated blobs (the f32 GEMMs round differently).
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from sklearn.metrics import adjusted_rand_score

from consensus_clustering_tpu.models.kmeans import KMeans as JaxKMeans
from consensus_clustering_tpu.ops.pallas_lloyd import (
    lloyd_step as jax_lloyd_step,
    pad_points,
)
from consensus_clustering_tpu_torch.convert import key_from_jax
from consensus_clustering_tpu_torch.data import make_blobs
from consensus_clustering_tpu_torch.models.kmeans import KMeans
from consensus_clustering_tpu_torch.ops import lloyd

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_step(x, c, k):
    sums, counts, far = jax_lloyd_step(
        pad_points(jnp.asarray(x)), jnp.asarray(c), jnp.int32(k),
        x.shape[0], interpret=True,
    )
    return np.asarray(sums), np.asarray(counts), np.asarray(far)


@pytest.mark.parametrize(
    "n,d,k_max,k,quantised",
    [(300, 7, 8, 5, False), (520, 50, 20, 20, False), (40, 3, 6, 2, False),
     (7, 4, 10, 6, False), (333, 9, 5, 5, True), (600, 13, 12, 9, True)],
)
def test_lloyd_step_plain_matches_reference_kernel(n, d, k_max, k, quantised):
    rs = np.random.default_rng(n + d)
    x = rs.normal(size=(n, d)).astype(np.float32)
    if quantised:
        x = (np.round(x * 16) / 8).astype(np.float32)
    c = x[rs.choice(n, size=k_max, replace=n < k_max)]
    ref_sums, ref_counts, ref_far = _jax_step(x, c, k)
    sums, counts, far = lloyd.lloyd_step(
        torch.tensor(x)[None], torch.zeros(1, dtype=torch.int64),
        torch.tensor(c)[None], k,
    )
    np.testing.assert_array_equal(counts[0].numpy(), ref_counts)
    np.testing.assert_array_equal(far[0].numpy(), ref_far)
    if quantised:
        np.testing.assert_array_equal(sums[0].numpy(), ref_sums)
    else:
        np.testing.assert_allclose(
            sums[0].numpy(), ref_sums, rtol=1e-5, atol=1e-5
        )


def test_lloyd_step_lanes_share_resamples():
    # Lanes index their resample: the same rows under two restarts.
    rs = np.random.default_rng(3)
    x = rs.normal(size=(3, 90, 4)).astype(np.float32)
    c = rs.normal(size=(6, 5, 4)).astype(np.float32)
    src = torch.tensor([0, 0, 1, 1, 2, 2])
    sums, counts, far = lloyd.lloyd_step(
        torch.tensor(x), src, torch.tensor(c), 4
    )
    for lane in range(6):
        ref = _jax_step(x[lane // 2], c[lane], 4)
        np.testing.assert_array_equal(counts[lane].numpy(), ref[1])
        np.testing.assert_array_equal(far[lane].numpy(), ref[2])
        np.testing.assert_allclose(sums[lane].numpy(), ref[0], rtol=1e-5,
                                   atol=1e-5)


def test_kernel_wrapper_refuses_cpu_tensors():
    x = torch.zeros(1, 8, 2)
    with pytest.raises(ValueError, match="CUDA"):
        lloyd.lloyd_step_kernel(
            x, torch.zeros(1, dtype=torch.int64), torch.zeros(1, 3, 2), 2
        )


_F64_SCRIPT = """
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
import json, sys
import jax.numpy as jnp
import numpy as np
from consensus_clustering_tpu.models.kmeans import KMeans
p = json.load(sys.stdin)
x = jnp.asarray(np.asarray(p["x"], np.float64))
c0 = jnp.asarray(np.asarray(p["c0"], np.float64))
labels, cen = KMeans(n_init=2).fit(
    jax.random.PRNGKey(0), x, p["k"], p["k_max"], init_centroids=c0)
print(json.dumps({"labels": np.asarray(labels).tolist(),
                  "centroids": np.asarray(cen).tolist()}))
"""


def test_kmeans_f64_labels_identical_from_injected_init():
    x, _ = make_blobs(n_samples=180, n_features=5, centers=4,
                      cluster_std=2.5, random_state=2)
    rs = np.random.default_rng(2)
    k, k_max = 4, 6
    c0 = np.stack([x[rs.choice(180, k_max, replace=False)] for _ in range(2)])
    env = dict(os.environ, JAX_ENABLE_X64="1", JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run(
        [sys.executable, "-c", _F64_SCRIPT],
        input=json.dumps({"x": x.tolist(), "c0": c0.tolist(), "k": k,
                          "k_max": k_max}),
        capture_output=True, text=True, timeout=300, env=env, cwd=REPO,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    ref = json.loads(proc.stdout.strip().splitlines()[-1])
    labels, cen = KMeans(n_init=2).fit(
        torch.zeros(1, 2, dtype=torch.int64), torch.tensor(x)[None], k,
        k_max, init_centroids=torch.tensor(c0)[None],
    )
    assert cen.dtype == torch.float64
    np.testing.assert_array_equal(labels[0].numpy(), ref["labels"])
    np.testing.assert_allclose(cen[0].numpy(), ref["centroids"], rtol=1e-12,
                               atol=1e-12)


@pytest.mark.parametrize("seed,k,n_init", [(0, 3, 3), (5, 3, 1), (9, 5, 2)])
def test_kmeans_f32_agrees_on_well_separated_blobs(blobs, seed, k, n_init):
    x, _ = blobs
    key = jax.random.PRNGKey(seed)
    ref_labels, _ = JaxKMeans(n_init=n_init).fit(key, jnp.asarray(x), k, 6)
    labels, _ = KMeans(n_init=n_init).fit(
        key_from_jax(np.asarray(jax.random.key_data(key)))[None],
        torch.tensor(x)[None], k, 6,
    )
    ref_labels = np.asarray(ref_labels)
    got = labels[0].numpy()
    assert (got == ref_labels).mean() >= 0.99
    assert adjusted_rand_score(ref_labels, got) >= 0.99


def test_init_centroids_then_fit_equals_self_seeded_fit(blobs):
    x, _ = blobs
    xt = torch.tensor(x)[None].expand(2, -1, -1)
    keys = torch.tensor([[0, 3], [0, 4]])
    km = KMeans(n_init=2)
    inits = km.init_centroids(keys, xt, 4, 5)
    a = km.fit_predict(keys, xt, 4, 5, init_centroids=inits)
    b = km.fit_predict(keys, xt, 4, 5)
    np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_kmeans_rejects_float64_off_the_cpu():
    x = torch.zeros(1, 4, 2, dtype=torch.float64, device="meta")
    with pytest.raises(ValueError, match="float64"):
        KMeans().fit(torch.zeros(1, 2, dtype=torch.int64), x, 2)
