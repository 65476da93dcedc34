"""The port's host backend (sklearn labels, device counts) against the
reference package's, on the CPU.

The plan is the reference's bit for bit and sklearn's labels are a pure
function of (seed, subsample), so Mij and Iij must equal the JAX host
backend's integer for integer; PAC may sit one float32 ulp away (ROADMAP
C3: XLA turns the CDF's divide into a multiply inside ``jit``), so it is
held to 1e-6.
"""

import dataclasses
import logging

import jax
import numpy as np
import pytest
from sklearn.cluster import DBSCAN
from sklearn.cluster import KMeans as SkKMeans
from sklearn.mixture import GaussianMixture as SkGMM

from consensus_clustering_tpu.config import SweepConfig as JaxSweepConfig
from consensus_clustering_tpu.models.sklearn_adapter import (
    SklearnClusterer as JaxSklearnClusterer,
)
from consensus_clustering_tpu.parallel.host import (
    run_host_sweep as jax_run_host_sweep,
)
from consensus_clustering_tpu_torch import ConsensusClustering, load_corr
from consensus_clustering_tpu_torch.convert import config_from_jax
from consensus_clustering_tpu_torch.models.protocol import HostClusterer
from consensus_clustering_tpu_torch.models.sklearn_adapter import (
    SklearnClusterer,
)
from consensus_clustering_tpu_torch.parallel.host import run_host_sweep

jax.config.update("jax_platforms", "cpu")

_CONFIG = JaxSweepConfig(n_samples=29, n_features=29, k_values=(2, 3, 5),
                         n_iterations=12, store_matrices=True)


@pytest.fixture(scope="module")
def corr():
    return load_corr(transform=True)


@pytest.fixture(scope="module")
def reference_host_run(corr):
    return jax_run_host_sweep(JaxSklearnClusterer(SkKMeans(n_init=3)),
                              _CONFIG, corr, 23, progress=False)


def _port_run(corr, **kwargs):
    return run_host_sweep(SklearnClusterer(SkKMeans(n_init=3)),
                          config_from_jax(dataclasses.asdict(_CONFIG)), corr,
                          23, progress=False, device="cpu", **kwargs)


def test_mij_iij_equal_the_jax_host_backend(corr, reference_host_run):
    ref, got = reference_host_run, _port_run(corr)
    np.testing.assert_array_equal(got["iij"], ref["iij"])
    np.testing.assert_array_equal(got["mij"], ref["mij"])
    assert got["mij"].dtype == got["iij"].dtype == np.int32
    np.testing.assert_allclose(got["pac_area"], ref["pac_area"], atol=1e-6)
    np.testing.assert_allclose(got["cdf"], ref["cdf"], atol=1e-6)
    assert got["cij"].shape == ref["cij"].shape == (3, 29, 29)


def test_threads_give_the_same_counts(corr):
    serial, threaded = _port_run(corr), _port_run(corr, n_jobs=3)
    for key in ("mij", "iij", "cij", "hist", "pac_area"):
        np.testing.assert_array_equal(threaded[key], serial[key])


def test_timing_schema(corr, reference_host_run):
    timing = _port_run(corr)["timing"]
    assert set(reference_host_run["timing"]) <= set(timing)
    assert len(timing["label_seconds_per_k"]) == 3
    assert len(timing["accumulate_seconds_per_k"]) == 3
    assert timing["device"] == "cpu"
    assert timing["kernel_launches"]["hist"] == 0  # plain versions on CPU


def test_api_host_path_equals_the_reference_api(corr):  # jaxlint: disable=JL018 -- corr.csv, H=12, sklearn labels on the host
    from consensus_clustering_tpu import ConsensusClustering as JaxCC

    kwargs = dict(clusterer=SkKMeans(), K_range=(2, 3, 5), n_iterations=12,
                  random_state=23, store_matrices=True, progress=False)
    ref = JaxCC(plot_cdf=False, **kwargs).fit(corr)
    got = ConsensusClustering(device="cpu", **kwargs, plot_cdf=False).fit(corr)
    for k in (2, 3, 5):
        np.testing.assert_array_equal(got.cdf_at_K_data[k]["mij"],
                                      ref.cdf_at_K_data[k]["mij"])
        assert got.cdf_at_K_data[k]["mij"].dtype == np.uint8
    np.testing.assert_array_equal(got.cdf_at_K_data[2]["iij"],
                                  ref.cdf_at_K_data[2]["iij"])
    assert got.best_k_ == ref.best_k_
    assert got.metrics_["kernel_launches"]["hist"] == 0


def test_sklearn_gmm_uses_n_components_and_drops_the_default_n_init(corr):  # jaxlint: disable=JL018 -- corr.csv, H=6 on the host
    cc = ConsensusClustering(clusterer=SkGMM(covariance_type="diag"),
                             K_range=(2, 3), n_iterations=6, random_state=1,
                             device="cpu", progress=False, plot_cdf=False)
    clusterer, is_host = cc._resolve_clusterer()
    assert is_host and isinstance(clusterer, HostClusterer)
    assert clusterer.options == {"n_init": 3}  # GaussianMixture has n_init
    cc.fit(corr)
    assert set(cc.cdf_at_K_data) == {2, 3}
    labels = clusterer.fit_predict_host(0, corr, 3)
    assert labels.dtype == np.int32 and set(labels) <= {0, 1, 2}


def test_host_backend_logs_what_it_ignores(corr, caplog):  # jaxlint: disable=JL018 -- corr.csv, H=4 on the host
    cc = ConsensusClustering(
        clusterer=SkKMeans(n_init=1), K_range=(2,), n_iterations=4,
        random_state=1, device="cpu", progress=False, stream_h_block=2,
        accum_repr="packed", progress_callback=lambda k, pac: None,
        plot_cdf=False)
    with caplog.at_level(logging.INFO):
        cc.fit(corr)
    text = caplog.text
    assert "stream_h_block" in text and "accum_repr" in text
    assert "progress_callback" in text
    assert "streaming" not in cc.metrics_


def test_progress_bars_on_the_host_backend(corr, capsys):
    run_host_sweep(SklearnClusterer(SkKMeans(n_init=1)),
                   config_from_jax(dataclasses.asdict(dataclasses.replace(
                       _CONFIG, k_values=(2,), n_iterations=3))),
                   corr, 1, progress=True, device="cpu")
    assert "Consensus clustering with 2 clusters" in capsys.readouterr().err


def test_estimator_without_a_cluster_count_raises():
    with pytest.raises(AttributeError, match="n_clusters nor n_components"):
        SklearnClusterer(DBSCAN())
    with pytest.raises(AttributeError, match="fit_predict"):
        SklearnClusterer(object())
