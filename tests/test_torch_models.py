"""The port's clusterer family against the reference package's, on the CPU.

Tolerances, each stated where it is checked:
- Monti's consensus statistics: equal to the reference's, NaNs included.
- ``rng.normal``: the uniform bits equal JAX's; the floats within rtol
  1e-5 (XLA's float32 ``erf_inv`` and torch's ``erfinv`` differ by up to
  ~90 ulps in the tails).
- ``agglomerate`` on a shared float32 distance matrix: identical labels,
  for all four linkages, tie-heavy matrices of small-integer ratios and
  several k; consensus labels of corr.csv's Cij identical.
- Gaussian mixture in float64 from the reference's own k-means init
  labels: identical labels; PAC on corr.csv in float64 inside the golden
  bands ``max(0.02, 0.25 * ref)`` with the golden K ranking; a NaN
  (non-positive-definite) lane as in JAX.
- Spectral: labels by ARI >= 0.95 against the reference (dense and
  LOBPCG); LOBPCG against ``eigh``; ``eigh`` at n <= 5 k_max.
- Every new clusterer gives the same counts under any ``cluster_batch``.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from sklearn.metrics import adjusted_rand_score

from consensus_clustering_tpu.models.agglomerative import (
    AgglomerativeClustering as JaxAgglomerative,
)
from consensus_clustering_tpu.models.agglomerative import (
    agglomerate as jax_agglomerate,
)
from consensus_clustering_tpu.models.agglomerative import (
    consensus_labels_from_cij as jax_consensus_labels,
)
from consensus_clustering_tpu.models.gmm import GaussianMixture as JaxGMM
from consensus_clustering_tpu.models.kmeans import KMeans as JaxKMeans
from consensus_clustering_tpu.models.spectral import (
    SpectralClustering as JaxSpectral,
)
from consensus_clustering_tpu.ops import analysis as jax_analysis
from consensus_clustering_tpu_torch import (
    AgglomerativeClustering,
    ConsensusClustering,
    GaussianMixture,
    SpectralClustering,
    load_corr,
    rng,
)
from consensus_clustering_tpu_torch.config import SweepConfig
from consensus_clustering_tpu_torch.convert import (
    clusterer_from_jax,
    key_from_jax,
)
from consensus_clustering_tpu_torch.data import make_blobs
from consensus_clustering_tpu_torch.models import agglomerative, spectral
from consensus_clustering_tpu_torch.models.agglomerative import (
    agglomerate,
    consensus_labels_from_cij,
)
from consensus_clustering_tpu_torch.ops.analysis import (
    cluster_consensus,
    item_consensus,
)
from consensus_clustering_tpu_torch.parallel.sweep import run_sweep

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")

# One compiled reference agglomeration per (n, linkage); k is traced.
_jax_agglomerate = jax.jit(jax_agglomerate, static_argnums=(2, 3))


def _port_key(key):
    return key_from_jax(np.asarray(jax.random.key_data(key)))


@pytest.fixture(scope="module")
def corr_cij():
    """Cij at K=4 of a small corr.csv KMeans fit on the port (float32)."""
    cc = ConsensusClustering(K_range=(4,), n_iterations=20, random_state=3,
                             store_matrices=True, device="cpu", plot_cdf=False)
    cc.fit(load_corr(transform=True))
    return cc.cdf_at_K_data[4]["cij"]


# -- consensus statistics and rng.normal ---------------------------------


@pytest.mark.parametrize("labels", [
    np.array([0, 0, 1, 1, 1, 2, 0, 1]),  # cluster 2 is a singleton: NaN
    np.array([3, 3, 3, 3, 0, 0, 5, 3]),
])
def test_consensus_statistics_equal_the_reference(labels):
    rs = np.random.default_rng(4)
    c = rs.random((8, 8)).astype(np.float32)
    c = (c + c.T) / 2
    np.fill_diagonal(c, 1.0)
    for port_fn, ref_fn in ((cluster_consensus, jax_analysis.cluster_consensus),
                            (item_consensus, jax_analysis.item_consensus)):
        got, ref = port_fn(c, labels), ref_fn(c, labels)
        np.testing.assert_array_equal(got, ref)  # NaN == NaN here
    sizes = np.unique(labels, return_counts=True)[1]
    np.testing.assert_array_equal(np.isnan(cluster_consensus(c, labels)),
                                  sizes < 2)


@pytest.mark.parametrize("seed,shape", [(0, (7,)), (23, (300, 10)),
                                        (12345, (4, 50, 3))])
def test_normal_matches_jax(seed, shape):
    key = jax.random.PRNGKey(seed)
    lo = np.nextafter(np.float32(-1), np.float32(0))
    ref_u = np.asarray(jax.random.uniform(key, shape, jnp.float32, lo, 1.0))
    got_u = rng.uniform(_port_key(key), shape, torch.float32, float(lo), 1.0)
    np.testing.assert_array_equal(got_u.numpy().view(np.int32),
                                  ref_u.view(np.int32))
    # The same key on purpose: normal draws exactly these uniforms.
    ref = np.asarray(jax.random.normal(key, shape, jnp.float32))  # jaxlint: disable=JL001 -- the uniforms above are normal's own
    got = rng.normal(_port_key(key), shape).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-7)
    # Batched keys: each row is its own key's draw.
    keys = torch.stack([_port_key(key), _port_key(jax.random.PRNGKey(1))])
    np.testing.assert_array_equal(rng.normal(keys, shape)[0].numpy(), got)


# -- agglomerative -------------------------------------------------------


def _tie_heavy(rs, n):
    """1 - Cij for Cij a ratio of small integers: exact ties everywhere."""
    h = int(rs.integers(2, 9))
    m = rs.integers(0, h + 1, size=(n, n))
    m = np.minimum(m, m.T)
    c = (m / h).astype(np.float32)
    np.fill_diagonal(c, 1.0)
    return (1.0 - c).astype(np.float32)


@pytest.mark.parametrize("linkage", ["single", "complete", "average", "ward"])
@pytest.mark.parametrize("n", [9, 24])
def test_agglomerate_labels_identical(linkage, n):
    rs = np.random.default_rng(n)
    x = rs.normal(size=(n, 3)).astype(np.float32)
    mats = [_tie_heavy(rs, n), _tie_heavy(rs, n),
            ((x[:, None] - x[None]) ** 2).sum(-1).astype(np.float32)]
    for dist in mats:
        batch = agglomerate(torch.tensor(np.stack([dist, dist[::-1, ::-1]])),
                            3, linkage)
        for k in (1, 2, 3, n // 2, n):
            ref = np.asarray(_jax_agglomerate(jnp.asarray(dist), k, n,
                                              linkage))
            got = agglomerate(torch.tensor(dist), k, linkage).numpy()
            np.testing.assert_array_equal(got, ref)
        # Lanes are independent: lane 0 of a batch is the lone run.
        np.testing.assert_array_equal(
            batch[0].numpy(), agglomerate(torch.tensor(dist), 3,
                                          linkage).numpy())


def test_argmin_takes_the_lowest_flat_index():
    d = torch.tensor([[5.0, 1.0, 1.0], [1.0, 5.0, 1.0], [1.0, 1.0, 5.0]])
    assert int(torch.argmin(d.reshape(-1))) == 1
    assert int(jnp.argmin(jnp.asarray(d.numpy()))) == 1


def test_consensus_labels_from_corr_cij_identical(corr_cij, monkeypatch):
    for linkage in ("average", "complete"):
        ref = jax_consensus_labels(corr_cij, 4, linkage=linkage)
        got = consensus_labels_from_cij(corr_cij, 4, linkage=linkage,
                                        device="cpu")
        np.testing.assert_array_equal(got, ref)
    monkeypatch.setattr(agglomerative, "AGGLOMERATION_LIMIT", 10)
    with pytest.raises(ValueError, match="exact-path limit"):
        consensus_labels_from_cij(corr_cij, 4, method="agglomerative",
                                  device="cpu")


def test_consensus_labels_spectral_regime(corr_cij, monkeypatch):
    """Above the limit the spectral path labels Cij: on corr.csv's Cij as
    the reference's spectral path does (ARI), and on a block Cij as the
    exact agglomeration does."""
    monkeypatch.setattr(agglomerative, "AGGLOMERATION_LIMIT", 10)
    got = consensus_labels_from_cij(corr_cij, 4, seed=3, device="cpu")
    ref = jax_consensus_labels(corr_cij, 4, limit=10, seed=3)
    assert adjusted_rand_score(ref, got) >= 0.95
    truth = np.repeat(np.arange(3), 20)
    rs = np.random.default_rng(1)
    block = np.where(truth[:, None] == truth[None], 0.9, 0.1)
    block = block + rs.uniform(-0.05, 0.05, block.shape)
    block = ((block + block.T) / 2).astype(np.float32)
    np.fill_diagonal(block, 1.0)
    spectral_labels = consensus_labels_from_cij(block, 3, device="cpu")
    monkeypatch.setattr(agglomerative, "AGGLOMERATION_LIMIT", 4096)
    exact = consensus_labels_from_cij(block, 3, device="cpu")
    assert adjusted_rand_score(truth, spectral_labels) == 1.0
    assert adjusted_rand_score(truth, exact) == 1.0


def test_agglomerative_inner_clusterer_bands_on_features():
    """Distances come from a GEMM, which the port cannot match bit for
    bit, so the inner clusterer gets a band: ARI >= 0.95 per resample."""
    x, _ = make_blobs(n_samples=60, n_features=4, centers=3,
                      cluster_std=1.0, random_state=1)
    x = x.astype(np.float32)
    for linkage in ("average", "ward"):
        ref = np.asarray(JaxAgglomerative(linkage).fit_predict(
            jax.random.PRNGKey(0), jnp.asarray(x), 3, 4))
        got = AgglomerativeClustering(linkage).fit_predict(
            torch.zeros(1, 2, dtype=torch.int64), torch.tensor(x)[None], 3, 4)
        assert adjusted_rand_score(ref, got[0].numpy()) >= 0.95


# -- Gaussian mixture ----------------------------------------------------


@pytest.mark.parametrize("k,n_init", [(3, 1), (4, 2)])
def test_gmm_f64_labels_identical_from_injected_init(k, n_init):
    x = load_corr(transform=True).astype(np.float64)  # n 29 < d 29 + 1
    key = jax.random.PRNGKey(5)
    with jax.enable_x64(True):
        xj = jnp.asarray(x)
        ref = np.asarray(JaxGMM(n_init=n_init).fit_predict(
            key, xj, jnp.int32(k), 5))
        rkeys = [key] if n_init == 1 else list(jax.random.split(key, n_init))
        labels0 = np.stack([np.asarray(JaxKMeans(n_init=1, max_iter=10)
                                       .fit_predict(rk, xj, jnp.int32(k), 5))
                            for rk in rkeys])
    xt = torch.tensor(x)[None].expand(n_init, -1, -1).contiguous()
    labels, lb = GaussianMixture(n_init=n_init).em(
        xt, torch.tensor(labels0), k, 5)
    assert lb.dtype == torch.float64 and torch.isfinite(lb).all()
    np.testing.assert_array_equal(labels[int(torch.argmax(lb))].numpy(), ref)


def test_gmm_pac_tracks_goldens_f64():  # jaxlint: disable=JL018 -- corr.csv, H=30, K=5..8 in f64: ~2 s
    """The non-slow twin of tests/test_parity.py's GMM golden test."""
    with open(os.path.join(FIXTURES, "reference_goldens.json")) as f:
        goldens = json.load(f)
    cc = ConsensusClustering(
        clusterer=GaussianMixture(), clusterer_options={"n_init": 2},
        K_range=range(5, 9), random_state=23, n_iterations=30,
        compute_dtype="float64", device="cpu", plot_cdf=False)
    cc.fit(load_corr(transform=True).astype(np.float64))
    ours = np.array([cc.cdf_at_K_data[k]["pac_area"] for k in range(5, 9)])
    ref = np.array([goldens["gmm_pac"][str(k)] for k in range(5, 9)])
    assert list(np.argsort(ours)) == list(np.argsort(ref)), (ours, ref)
    assert (np.abs(ours - ref) <= np.maximum(0.02, 0.25 * ref)).all()
    assert all(a >= b - 0.02 for a, b in zip(ours, ours[1:]))


def test_gmm_nan_lane_is_handled_as_in_jax():
    """A lane whose covariances are singular (every point repeated,
    ``reg_covar=0``) gets NaN Cholesky factors: its lower bound is NaN,
    its loop stops, its labels are argmax over NaN (0, as JAX); the other
    lane is untouched."""
    rs = np.random.default_rng(0)
    centres = np.repeat(rs.normal(size=(3, 4)).astype(np.float32) * 5, 10, 0)
    degenerate = centres
    regular = centres + rs.normal(size=(30, 4)).astype(np.float32)
    x = np.stack([degenerate, regular])
    key = jax.random.PRNGKey(3)
    gmm = GaussianMixture(n_init=2, reg_covar=0.0)
    got = gmm.fit_predict(_port_key(key)[None].expand(2, 2),
                          torch.tensor(x), 3, 4)
    for lane in range(2):
        ref = np.asarray(JaxGMM(n_init=2, reg_covar=0.0).fit_predict(
            key, jnp.asarray(x[lane]), jnp.int32(3), 4))
        np.testing.assert_array_equal(got[lane].numpy(), ref)
    labels0 = torch.tensor(np.tile(np.repeat(np.arange(3), 10), (2, 1)))
    labels, lb = GaussianMixture(reg_covar=0.0).em(torch.tensor(x), labels0,
                                                   3, 4)
    assert torch.isnan(lb[0]) and torch.isfinite(lb[1])
    assert (labels[0] == 0).all()
    # Restart selection over a NaN bound picks the NaN, as jnp.argmax.
    bounds = [1.0, float("nan"), 3.0]
    assert int(torch.argmax(torch.tensor(bounds))) == int(
        jnp.argmax(jnp.asarray(bounds))) == 1


# -- spectral ------------------------------------------------------------


@pytest.fixture(scope="module")
def spectral_blobs():
    x, y = make_blobs(n_samples=240, n_features=5, centers=4,
                      cluster_std=1.5, random_state=2)
    return x.astype(np.float32), y


@pytest.mark.parametrize("solver", ["dense", "lobpcg"])
def test_spectral_labels_agree_with_reference(spectral_blobs, solver):
    x, y = spectral_blobs
    key = jax.random.PRNGKey(1)
    ref = np.asarray(JaxSpectral(gamma=0.1, solver=solver).fit_predict(
        key, jnp.asarray(x), jnp.int32(4), 6))
    got = SpectralClustering(gamma=0.1, solver=solver).fit_predict(
        _port_key(key)[None], torch.tensor(x)[None], 4, 6)[0].numpy()
    assert adjusted_rand_score(ref, got) >= 0.95
    assert adjusted_rand_score(y, got) >= 0.95


def test_lobpcg_against_eigh():
    """Top eigenpairs of a normalised affinity: eigenvalues within 1e-4 of
    ``eigh``'s and the subspace of the well-separated ones recovered."""
    x, _ = make_blobs(n_samples=150, n_features=3, centers=3,
                      cluster_std=1.0, random_state=0)
    a = spectral.rbf_affinity(torch.tensor(x, dtype=torch.float32)[None],
                              0.5)
    inv = torch.rsqrt(a.sum(-1))
    a = a * inv[..., :, None] * inv[..., None, :]
    x0 = rng.normal(torch.tensor([0, 9]), (150, 6))
    theta, vecs, iters = spectral.lobpcg_standard(a[0], x0, m=64)
    w, u = torch.linalg.eigh(a[0])
    np.testing.assert_allclose(theta.numpy(), w.flip(0)[:6].numpy(),
                               atol=1e-4)
    overlap = torch.linalg.svdvals(u[:, -3:].T @ vecs[:, :3])
    assert overlap.min() > 0.999
    assert 0 < iters <= 64
    np.testing.assert_allclose((vecs.T @ vecs).numpy(), np.eye(6), atol=1e-4)


def test_lobpcg_falls_back_to_eigh_at_small_n(monkeypatch):
    with pytest.raises(ValueError, match="search dim"):
        spectral.lobpcg_standard(torch.eye(10), torch.ones(10, 2))
    x, _ = make_blobs(n_samples=30, n_features=3, centers=3, random_state=0)
    x = torch.tensor(x, dtype=torch.float32)[None]
    keys = torch.tensor([[0, 4]])
    with pytest.raises(ValueError, match="solver"):
        SpectralClustering(solver="arpack").fit_predict(keys, x, 3, 6)
    calls = []
    monkeypatch.setattr(spectral, "lobpcg_standard",
                        lambda *a, **k: calls.append(a))
    lob = SpectralClustering(solver="lobpcg", gamma=0.5).fit_predict(
        keys, x, 3, 6)  # n = 30 <= 5 * 6: eigh
    dense = SpectralClustering(solver="dense", gamma=0.5).fit_predict(
        keys, x, 3, 6)
    assert not calls
    np.testing.assert_array_equal(lob.numpy(), dense.numpy())


def test_spectral_rounding_picks_the_basis_below_the_component_count():  # jaxlint: disable=JL018 -- N=300, H=10 on the CPU port
    """Three blobs disconnected in the affinity graph: the top eigenvalue
    has multiplicity 3.  Moving the input by one ulp leaves the K=3 counts
    (the whole eigenspace) as they were and changes the K=2 counts (two
    columns of a basis that rounding picks), which is why the card is held
    to the CPU at K >= 3 only (``tests/test_torch_cuda.py::
    test_spectral_on_the_card``)."""
    x, _ = make_blobs(n_samples=300, n_features=5, centers=3,
                      cluster_std=1.0, random_state=1)
    x = x.astype(np.float32)
    config = SweepConfig(n_samples=300, n_features=5, k_values=(2, 3),
                         n_iterations=10)
    clusterer = SpectralClustering(gamma=0.2, solver="lobpcg")
    base, moved = (run_sweep(clusterer, config, v, 5, device="cpu")["mij"]
                   for v in (x, np.nextafter(x, np.float32(np.inf))))
    np.testing.assert_array_equal(base[1], moved[1])
    assert not np.array_equal(base[0], moved[0])


# -- grouping invariance and conversion ----------------------------------


@pytest.mark.parametrize("clusterer", [
    GaussianMixture(n_init=2),
    AgglomerativeClustering("average"),
    SpectralClustering(gamma=0.2, solver="lobpcg", n_init=2),
], ids=["gmm", "agglomerative", "spectral"])
def test_cluster_batch_gives_identical_counts(clusterer):  # jaxlint: disable=JL018 -- N=80, H=10 on the CPU port
    x, _ = make_blobs(n_samples=80, n_features=3, centers=3,
                      cluster_std=1.5, random_state=6)
    x = x.astype(np.float32)
    outs = [run_sweep(clusterer, SweepConfig(
        n_samples=80, n_features=3, k_values=(2, 3), n_iterations=10,
        cluster_batch=batch), x, 5, device="cpu")
        for batch in (None, 3)]
    for key in ("mij", "iij", "hist", "pac_area"):
        np.testing.assert_array_equal(outs[0][key], outs[1][key])


def test_clusterer_from_jax():
    for ref in (JaxGMM(n_init=2, tol=1e-4), JaxAgglomerative("single"),
                JaxSpectral(gamma=0.3, solver="lobpcg", lobpcg_iters=8)):
        got = clusterer_from_jax(type(ref).__name__, dataclasses.asdict(ref))
        assert type(got).__name__ == type(ref).__name__
        assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    km = clusterer_from_jax("KMeans", dataclasses.asdict(JaxKMeans(n_init=2)))
    assert km.n_init == 2
    with pytest.raises(ValueError, match="unknown clusterer"):
        clusterer_from_jax("DBSCAN", {})
    with pytest.raises(ValueError, match="no field"):
        clusterer_from_jax("GaussianMixture", {"covariance_type": "diag"})
