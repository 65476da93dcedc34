"""The port's dense sweep and API against the reference package's.

- run_sweep on blobs against the reference run_sweep (same seed, config
  and KMeans): Iij bit-identical (same plan), PAC within 0.02 per K, and
  on 3 well-separated blobs Mij identical at K=3.
- cluster_batch groups and split_init give the same counts as one batch.
- corr.csv through ConsensusClustering: the golden bands, monotone tail
  and Iij sum of tests/test_parity.py.
"""

import dataclasses
import json
import os

import numpy as np
import pytest

from consensus_clustering_tpu.config import SweepConfig as JaxSweepConfig
from consensus_clustering_tpu.models.kmeans import KMeans as JaxKMeans
from consensus_clustering_tpu.parallel.sweep import run_sweep as jax_run_sweep
from consensus_clustering_tpu_torch import ConsensusClustering, load_corr
from consensus_clustering_tpu_torch.config import SweepConfig
from consensus_clustering_tpu_torch.convert import (
    config_from_jax,
    kmeans_from_jax,
)
from consensus_clustering_tpu_torch.data import make_blobs
from consensus_clustering_tpu_torch.models.kmeans import KMeans
from consensus_clustering_tpu_torch.parallel.sweep import run_sweep

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")


def _both(x, jax_config, jax_kmeans, seed):
    ref = jax_run_sweep(jax_kmeans, jax_config, x, seed)
    got = run_sweep(
        kmeans_from_jax(dataclasses.asdict(jax_kmeans)),
        config_from_jax(dataclasses.asdict(jax_config)), x, seed,
        device="cpu",
    )
    return ref, got


@pytest.mark.parametrize("seed", [3, 11])
def test_sweep_matches_reference_on_blobs(seed):  # jaxlint: disable=JL018 -- N=150, H=24: a few seconds
    x, _ = make_blobs(n_samples=150, n_features=6, centers=4,
                      cluster_std=2.0, random_state=seed)
    x = x.astype(np.float32)
    config = JaxSweepConfig(
        n_samples=150, n_features=6, k_values=(2, 3, 4, 5, 6),
        n_iterations=24, store_matrices=True, chunk_size=5, cluster_batch=7,
    )
    ref, got = _both(x, config, JaxKMeans(n_init=2), seed)
    np.testing.assert_array_equal(got["iij"], ref["iij"])
    assert np.abs(got["pac_area"] - ref["pac_area"]).max() <= 0.02
    assert got["hist"].shape == ref["hist"].shape == (5, 20)
    assert np.isfinite(got["cdf"]).all()


def test_sweep_mij_identical_on_separated_blobs(blobs):  # jaxlint: disable=JL018 -- N=120, H=16: a few seconds
    x, _ = blobs
    config = JaxSweepConfig(
        n_samples=120, n_features=5, k_values=(2, 3, 4), n_iterations=16,
        store_matrices=True, chunk_size=4,
    )
    ref, got = _both(x, config, JaxKMeans(n_init=3), 23)
    np.testing.assert_array_equal(got["iij"], ref["iij"])
    np.testing.assert_array_equal(got["mij"][1], ref["mij"][1])  # K=3
    np.testing.assert_array_equal(
        got["cij"][1].view(np.uint32), ref["cij"][1].view(np.uint32)
    )
    assert np.abs(got["pac_area"] - ref["pac_area"]).max() <= 0.02


@pytest.mark.parametrize(
    "cluster_batch,split_init,reseed",
    [(None, False, False), (5, False, False), (5, True, False),
     (4, True, True), (32, False, True)],
)
def test_grouping_gives_identical_counts(cluster_batch, split_init, reseed):  # jaxlint: disable=JL018 -- CPU port only, N=90
    x, _ = make_blobs(n_samples=90, n_features=4, centers=3,
                      cluster_std=2.5, random_state=4)
    base = SweepConfig(
        n_samples=90, n_features=4, k_values=(2, 4, 5), n_iterations=13,
        reseed_clusterer_per_resample=reseed,
    )
    one = run_sweep(KMeans(n_init=2), base, x, 5, device="cpu")
    grouped = run_sweep(
        KMeans(n_init=2),
        dataclasses.replace(base, cluster_batch=cluster_batch,
                            split_init=split_init),
        x, 5, device="cpu",
    )
    np.testing.assert_array_equal(grouped["mij"], one["mij"])
    np.testing.assert_array_equal(grouped["pac_area"], one["pac_area"])


def test_api_result_schema(blobs):  # jaxlint: disable=JL018 -- CPU port only, N=120
    x, _ = blobs
    cc = ConsensusClustering(
        K_range=range(2, 6), n_iterations=20, random_state=0, device="cpu",
        plot_cdf=False,
    ).fit(x)
    assert sorted(cc.cdf_at_K_data) == [2, 3, 4, 5]
    entry = cc.cdf_at_K_data[3]
    assert set(entry) == {"consensus_labels", "hist", "cdf", "bin_edges",
                          "pac_area", "mij", "iij", "cij"}
    assert entry["consensus_labels"] == []
    assert entry["mij"].dtype == entry["iij"].dtype == np.uint8
    assert entry["cij"].dtype == np.float32
    assert entry["hist"].dtype == entry["cdf"].dtype == np.float64
    np.testing.assert_array_equal(entry["bin_edges"], np.linspace(0, 1, 21))
    assert cc.best_k_ == 3
    assert cc.areas_.shape == cc.delta_k_.shape == (4,)
    assert cc.metrics_["kernel_launches"] == {
        "hist": 0, "lloyd": 0, "popcount": 0, "fused_block": 0, "assign": 0,
    }
    assert cc.metrics_["device"] == "cpu"


def test_api_delta_k_mode(blobs):  # jaxlint: disable=JL018 -- CPU port only, N=120
    x, _ = blobs
    cc = ConsensusClustering(
        K_range=range(2, 5), n_iterations=12, random_state=1, device="cpu",
        consensus_matrix_analysis="delta_k", store_matrices=False,
        plot_cdf=False,
    ).fit(x)
    assert cc.cdf_at_K_data[2]["mij"] is None
    assert cc.best_k_ in (2, 3, 4)


@pytest.fixture(scope="module")
def corr_fit():
    cc = ConsensusClustering(
        K_range=range(2, 15), random_state=23, n_iterations=30,
        store_matrices=True, device="cpu", plot_cdf=False,
    )
    return cc.fit(load_corr(transform=True))


@pytest.fixture(scope="module")
def goldens():
    with open(os.path.join(FIXTURES, "reference_goldens.json")) as f:
        return json.load(f)


def test_corr_pac_tracks_goldens(corr_fit, goldens):
    from scipy.stats import spearmanr

    ours = np.array([corr_fit.cdf_at_K_data[k]["pac_area"]
                     for k in range(2, 15)])
    ref = np.array([goldens["kmeans_pac"][str(k)] for k in range(2, 15)])
    assert spearmanr(ours, ref).statistic > 0.95
    band = np.maximum(0.02, 0.25 * ref)
    assert (np.abs(ours - ref) <= band).all(), (ours, ref)


def test_corr_monotone_tail(corr_fit):
    pac = [corr_fit.cdf_at_K_data[k]["pac_area"] for k in range(4, 15)]
    assert all(a >= b - 0.02 for a, b in zip(pac, pac[1:]))


def test_corr_iij_sum_matches_golden(corr_fit, goldens):
    iij = corr_fit.cdf_at_K_data[2]["iij"].astype(np.int64)
    assert int(iij.sum()) == goldens["iij_sum"]
