"""The port's Lloyd step and KMeans against the reference package's.

- Lloyd step: the port's plain version against the reference Pallas kernel
  in interpret mode.  Counts and far-point indices exact; sums to rtol
  1e-5, and exact on data quantised to multiples of 1/8, where every sum is
  representable.
- The ordered plain version (the CUDA kernel's arithmetic op by op): exact
  against the reference kernel on quantised data; on raw data its counts
  and far points follow the final assignment's labels exactly, and its
  sums are within 1e-5 of the GEMM plain version's.
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
from consensus_clustering_tpu_torch.ops import fused_block, lloyd

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


@pytest.mark.parametrize(
    "n,d,k_max,k",
    [(300, 7, 8, 5), (650, 13, 12, 9), (129, 50, 20, 20), (57, 4, 10, 6)],
)
def test_ordered_plain_equals_reference_kernel_on_quantised_data(n, d, k_max,
                                                                 k):
    # n not a multiple of 128 (ragged last tile), k < k_max in three cases.
    rs = np.random.default_rng(10 * n + d)
    x = (np.round(rs.normal(size=(n, d)) * 16) / 8).astype(np.float32)
    c = x[rs.choice(n, size=k_max, replace=n < k_max)]
    ref_sums, ref_counts, ref_far = _jax_step(x, c, k)
    sums, counts, far = lloyd.lloyd_step_ordered_plain(
        torch.tensor(x)[None], torch.zeros(1, dtype=torch.int32),
        torch.tensor(c)[None], k,
    )
    np.testing.assert_array_equal(sums[0].numpy(), ref_sums)
    np.testing.assert_array_equal(counts[0].numpy(), ref_counts)
    np.testing.assert_array_equal(far[0].numpy(), ref_far)


def _raw_lanes(seed, b, n, d, n_init, k_max):
    rs = np.random.default_rng(seed)
    x = torch.tensor(rs.normal(size=(b, n, d)).astype(np.float32) * 3)
    src = torch.arange(b, dtype=torch.int32).repeat_interleave(n_init)
    pick = torch.tensor(rs.integers(0, n, size=(b * n_init, k_max)))
    return x, src, x[src.long()[:, None], pick]


@pytest.mark.parametrize("b,n,d,n_init,k_max,k", [(2, 300, 50, 3, 20, 20),
                                                  (3, 257, 9, 2, 13, 9),
                                                  (1, 140, 300, 2, 40, 33)])
def test_ordered_plain_counts_and_far_points_follow_assign_labels(
        b, n, d, n_init, k_max, k):
    # Raw data: counts and far points are those of the final assignment's
    # own labels and min-distances (the same op-by-op distances).
    x, src, cen = _raw_lanes(b * n + d, b, n, d, n_init, k_max)
    _, counts, far = lloyd.lloyd_step_ordered_plain(x, src, cen, k)
    labels, d_min = fused_block.assign_labels_plain(x, src, cen, k)
    onehot = torch.nn.functional.one_hot(labels, k_max)
    assert torch.equal(counts, onehot.sum(dim=1).to(counts.dtype))
    assert torch.equal(far, lloyd.bucket_far_points(d_min, k_max))


@pytest.mark.parametrize("seed,k", [(1, 8), (2, 5), (3, 12)])
def test_ordered_plain_sums_match_gemm_plain_version(seed, k):
    # Raw well-separated blobs, centroids at the centres: no label near a
    # tie, so only the order of the sums differs from the GEMM's.
    x, y = make_blobs(n_samples=700, n_features=11, centers=k,
                      cluster_std=1.0, random_state=seed)
    means = np.stack([x[y == j].mean(axis=0) for j in range(k)])
    xt = torch.tensor(x, dtype=torch.float32)[None]
    cen = torch.tensor(np.concatenate([means, means[:2] + 50.0]),
                       dtype=torch.float32)[None].repeat(2, 1, 1)
    src = torch.zeros(2, dtype=torch.int32)
    got = lloyd.lloyd_step_ordered_plain(xt, src, cen, k)
    ref = lloyd.lloyd_step_plain(xt, src, cen, k)
    np.testing.assert_allclose(got[0].numpy(), ref[0].numpy(), rtol=1e-5,
                               atol=1e-5)
    assert torch.equal(got[1], ref[1])
    assert torch.equal(got[2], ref[2])


@pytest.mark.parametrize("lanes,b,n,expected", [
    (48, 16, 4000, 3),   # the headline: a resample's 3 restarts share
    (40, 16, 4000, 2),   # converged lanes dropped out: 2 a block
    (5, 16, 4000, 1),    # fewer lanes than resamples
    (48, 16, 300, 1),    # 3 tiles x 16 blocks would underfill the card
])
def test_lanes_per_block(lanes, b, n, expected):
    assert fused_block.lanes_per_block(lanes, b, n) == expected


@pytest.mark.parametrize("d,k_max,vec,fused_vec", [
    (50, 20, True, True),     # the headline: 16-byte slot groups
    (401, 60, True, None),    # B2 and assign chunk the slots; B4 refuses
    (445, 2, False, False),   # 4 padded slots do not fit: unpadded slots
])
def test_layouts_fall_back_to_unpadded_slots_only_where_padding_does_not_fit(
        d, k_max, vec, fused_vec):
    for extra in (2 * lloyd.TILE_ROWS, 0):  # B2's layout, the assignment's
        assert fused_block.tile_layout(d, k_max, extra)[3] is vec
    fused = fused_block.fused_layout(d, k_max)
    assert (fused and fused[2]) is fused_vec


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
