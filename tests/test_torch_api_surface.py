"""The rest of the reference constructor, consensus labels and
``fit_predict`` on the port, on the CPU.

- Every keyword of the reference constructor is a keyword of the port's
  (which adds ``device``), with the reference's defaults (``plot_cdf=True``
  among them), and the reference's own ``ValueError``s are kept.
- ``k_batch_size`` equals the one-batch fit bit for bit (monolithic and
  streamed), and so does a fit resumed from a batch's checkpoint.
- ``metrics_path`` writes the reference's events with its fields.
- ``fit_predict`` raises before the sweep without matrices, and with the
  reference's message after a resume without them; consensus labels and
  Monti's statistics equal the reference functions on the same Cij.
"""

import inspect
import json
import os

import jax
import numpy as np
import pytest
from sklearn.metrics import adjusted_rand_score

from consensus_clustering_tpu import ConsensusClustering as JaxCC
from consensus_clustering_tpu.models.agglomerative import (
    consensus_labels_from_cij as jax_consensus_labels,
)
from consensus_clustering_tpu.ops import analysis as jax_analysis
from consensus_clustering_tpu_torch import (
    AgglomerativeClustering,
    ConsensusClustering,
    GaussianMixture,
    make_blobs,
)
from consensus_clustering_tpu_torch.parallel import sweep as port_sweep

jax.config.update("jax_platforms", "cpu")

_KEYS = ("hist", "cdf", "pac_area", "mij", "iij", "cij")


@pytest.fixture(scope="module")
def blobs3():
    x, y = make_blobs(n_samples=90, n_features=4, centers=3,
                      cluster_std=1.0, random_state=4)
    return x.astype(np.float32), y


def _fit(x, **kwargs):
    base = dict(K_range=(2, 3, 4, 5), n_iterations=12, random_state=9,
                store_matrices=True, device="cpu")
    base.update(kwargs)
    return ConsensusClustering(**base, plot_cdf=False).fit(x)


def _assert_same(a, b):
    assert list(a.cdf_at_K_data) == list(b.cdf_at_K_data)
    for k, entry in a.cdf_at_K_data.items():
        for key in _KEYS:
            np.testing.assert_array_equal(entry[key], b.cdf_at_K_data[k][key])
    assert a.best_k_ == b.best_k_


# -- the constructor -----------------------------------------------------


def test_every_reference_keyword_is_a_port_keyword():
    ref = inspect.signature(JaxCC.__init__).parameters
    port = inspect.signature(ConsensusClustering.__init__).parameters
    assert set(port) - set(ref) == {"device"}
    assert set(ref) <= set(port)
    for name, param in ref.items():
        assert port[name].kind == param.kind, name


@pytest.mark.parametrize("kwargs,match", [
    (dict(n_pairs=64), "only applies"),
    (dict(n_pairs=0), "n_pairs must be"),
    (dict(mode="progressive"), "serving mode"),
    (dict(mode="sampled"), "mode must be"),
    (dict(k_batch_size=0), "k_batch_size"),
])
def test_reference_value_errors_are_kept(kwargs, match):
    with pytest.raises(ValueError, match=match):
        JaxCC(random_state=0, **kwargs, plot_cdf=False)
    with pytest.raises(ValueError, match=match):
        ConsensusClustering(random_state=0, **kwargs, plot_cdf=False)


def test_use_pallas_false_is_refused():
    with pytest.raises(ValueError, match="use_pallas=False"):
        ConsensusClustering(use_pallas=False, plot_cdf=False)


def test_ported_keywords_construct(tmp_path):
    cc = ConsensusClustering(
        clusterer=GaussianMixture(), compute_consensus_labels=True,
        progress=False, use_pallas=True, profile_dir=str(tmp_path / "p"),
        metrics_path=str(tmp_path / "m.jsonl"), k_batch_size=2,
        split_init=None, n_jobs=2, memmap_folder=str(tmp_path), plot_cdf=False)
    assert cc.progress is False and cc.k_batch_size == 2
    assert not os.path.exists(tmp_path / "p")  # construction writes nothing
    est = ConsensusClustering(mode="estimate", n_pairs=64, exact_best_k=True,
                              plot_cdf=False)
    assert (est.mode, est.n_pairs, est.exact_best_k) == ("estimate", 64, True)


def test_default_n_init_is_dropped_only_where_there_is_none():
    cc = ConsensusClustering(clusterer=AgglomerativeClustering("average"),
                             plot_cdf=False)
    clusterer, is_host = cc._resolve_clusterer()
    assert not is_host and clusterer == AgglomerativeClustering("average")
    assert ConsensusClustering(clusterer=GaussianMixture(), plot_cdf=False
                               )._resolve_clusterer()[0].n_init == 3
    explicit = ConsensusClustering(clusterer=AgglomerativeClustering(),
                                   clusterer_options={"n_init": 3},
                                   plot_cdf=False)
    with pytest.raises(ValueError, match="invalid clusterer option"):
        explicit._resolve_clusterer()
    with pytest.raises(TypeError, match="neither"):
        ConsensusClustering(clusterer=object(),
                            plot_cdf=False)._resolve_clusterer()


# -- k_batch_size --------------------------------------------------------


@pytest.mark.parametrize("engine", [
    dict(),
    dict(stream_h_block=5),
    dict(stream_h_block=5, accum_repr="packed"),
], ids=["monolithic", "streamed", "streamed-packed"])
def test_k_batch_size_equals_one_batch(blobs3, engine):  # jaxlint: disable=JL018 -- N=90, H=12 on the CPU port
    x, _ = blobs3
    one = _fit(x, **engine)
    for size in (1, 3):
        batched = _fit(x, k_batch_size=size, **engine)
        _assert_same(batched, one)
        assert batched.metrics_["n_batches"] == -(-4 // size)
        if engine:
            assert len(batched.metrics_["streaming_batches"]) == -(-4 // size)
            assert batched.metrics_["streaming"] == (
                batched.metrics_["streaming_batches"][-1])
    assert one.metrics_["n_batches"] == 1
    assert "streaming_batches" not in one.metrics_


def test_k_batch_resume_from_a_batch_checkpoint(blobs3, tmp_path):  # jaxlint: disable=JL018 -- N=90, H=12 on the CPU port
    x, _ = blobs3
    one = _fit(x)

    def crash_at_4(k, pac):
        if k == 4:
            raise RuntimeError("crash in the second batch")

    with pytest.raises(RuntimeError, match="second batch"):
        _fit(x, k_batch_size=2, checkpoint_dir=str(tmp_path),
             progress_callback=crash_at_4)
    resumed = _fit(x, k_batch_size=2, checkpoint_dir=str(tmp_path))
    assert resumed.metrics_["resumed_ks"] == [2, 3]
    assert resumed.metrics_["n_batches"] == 1
    _assert_same(resumed, one)


# -- metrics_path --------------------------------------------------------


def _events(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def test_metrics_path_events_match_the_reference(blobs3, tmp_path):
    x, _ = blobs3
    runs = {}
    for name, cls, extra in (("ref", JaxCC, {}),
                             ("port", ConsensusClustering,
                              dict(device="cpu"))):
        for engine, kwargs in (("mono", dict(k_batch_size=1)),
                               ("stream", dict(stream_h_block=4))):
            path = str(tmp_path / f"{name}-{engine}.jsonl")
            cls(K_range=(2, 3), n_iterations=8, random_state=3,
                metrics_path=path, store_matrices=False, **kwargs,
                **extra, plot_cdf=False).fit(x)
            runs[name, engine] = _events(path)
    for engine in ("mono", "stream"):
        ref, port = runs["ref", engine], runs["port", engine]
        assert [e["event"] for e in port] == [e["event"] for e in ref]
        for r, p in zip(ref, port):
            missing = set(r) - set(p)
            assert not missing, (r["event"], missing)
    mono = runs["port", "mono"]
    assert [e["event"] for e in mono] == [
        "k_batch_complete", "k_batch_complete", "sweep_complete"]
    assert [e["k_values"] for e in mono[:2]] == [[2], [3]]
    assert mono[-1]["pac_area"].keys() == {"2", "3"}
    stream = runs["port", "stream"]
    assert [e["h_done"] for e in stream[:2]] == [4, 8]


# -- consensus labels and fit_predict ------------------------------------


def test_compute_consensus_labels_equal_the_reference_functions(blobs3):  # jaxlint: disable=JL018 -- N=90, H=12 on the CPU port
    x, y = blobs3
    cc = _fit(x, compute_consensus_labels=True, agg_clustering_linkage="complete")
    for k, entry in cc.cdf_at_K_data.items():
        labels = entry["consensus_labels"]
        np.testing.assert_array_equal(
            labels, jax_consensus_labels(entry["cij"], k, linkage="complete"))
        np.testing.assert_array_equal(
            entry["cluster_consensus"],
            jax_analysis.cluster_consensus(entry["cij"], labels))
        np.testing.assert_array_equal(
            entry["item_consensus"],
            jax_analysis.item_consensus(entry["cij"], labels))
    assert adjusted_rand_score(y, cc.cdf_at_K_data[3]["consensus_labels"]) == 1
    with pytest.raises(ValueError, match="needs the consensus matrices"):
        _fit(x, compute_consensus_labels=True, store_matrices=False)


def test_fit_predict(blobs3):
    x, y = blobs3
    cc = ConsensusClustering(K_range=(2, 3, 4), n_iterations=12,
                             random_state=9, store_matrices=True,
                             device="cpu", plot_cdf=False)
    labels = cc.fit_predict(x)
    assert cc.best_k_ == 3
    assert adjusted_rand_score(y, labels) == 1.0
    np.testing.assert_array_equal(cc.cdf_at_K_data[3]["consensus_labels"],
                                  labels)


def test_fit_predict_raises_before_the_sweep(blobs3, monkeypatch):
    x, _ = blobs3
    monkeypatch.setattr(port_sweep, "run_sweep",
                        lambda *a, **k: pytest.fail("the sweep ran"))
    cc = ConsensusClustering(K_range=(2, 3), random_state=0,
                             store_matrices=False, device="cpu",
                             plot_cdf=False)
    with pytest.raises(ValueError, match="fit_predict needs the consensus"):
        cc.fit_predict(x)


def test_fit_predict_after_a_resume_without_matrices(blobs3, tmp_path):  # jaxlint: disable=JL018 -- N=90, H=6 on the CPU port
    x, _ = blobs3
    kwargs = dict(K_range=(2, 3), n_iterations=6, random_state=0,
                  device="cpu", checkpoint_dir=str(tmp_path))
    ConsensusClustering(store_matrices=False, **kwargs, plot_cdf=False).fit(x)
    cc = ConsensusClustering(store_matrices=True, **kwargs, plot_cdf=False)
    with pytest.raises(ValueError, match="resumed from checkpoints"):
        cc.fit_predict(x)
    assert cc.metrics_["resumed_from_checkpoint"] is True


def test_profile_dir_writes_a_trace(blobs3, tmp_path):  # jaxlint: disable=JL018 -- N=90, H=4, one K on the CPU port
    x, _ = blobs3
    out = tmp_path / "trace"
    _fit(x, K_range=(2,), n_iterations=4, profile_dir=str(out))
    traces = [f for f in os.listdir(out) if f.endswith(".json")]
    assert len(traces) == 1
    with open(out / traces[0]) as f:
        assert json.load(f)["traceEvents"]
