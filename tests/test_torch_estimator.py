"""The port's sampled-pair estimator against the reference package's, and
against the port's own dense sweep.

- ``pair_key`` and ``sample_pairs`` equal JAX's bit for bit; the bounds
  copy equals the reference's functions exactly.
- Every sampled pair's counts equal the port's dense Mij/Iij entries bit
  for bit, on both pair paths; against the reference's
  ``run_pair_estimate`` on the same inputs Iij is equal bit for bit, Mij
  equal on separated blobs, PAC within max(0.02, 0.25·ref) per K; the
  disclosed bound covers the observed error.
- An injected ``block_start`` fault resumes bit for bit; a flipped bit
  fails ``verify_pair_state_frame``; a streamed-sweep frame is refused;
  the O(M) sentinel catches an accumulator bitflip.
- The tiled exact curves equal the reference's numpy ones bit for bit at
  several tile sizes, and ``exact_curves_for_k`` equals the dense sweep's
  curve for that K.
- The API: ``mode="estimate"`` fills the reference's keys, ``mode="auto"``
  follows the budget, ``exact_best_k`` refines at ``h_effective``, and the
  reference's ValueErrors.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from consensus_clustering_tpu.config import SweepConfig as JaxSweepConfig
from consensus_clustering_tpu.estimator import bounds as jax_bounds
from consensus_clustering_tpu.estimator.engine import (
    PairConsensusEngine as JaxPairConsensusEngine,
)
from consensus_clustering_tpu.estimator.sampler import (
    pair_key as jax_pair_key,
    sample_pairs as jax_sample_pairs,
)
from consensus_clustering_tpu.estimator.tiled import (
    collect_resample_labels as jax_collect_resample_labels,
    tiled_exact_curves as jax_tiled_exact_curves,
)
from consensus_clustering_tpu.models.kmeans import KMeans as JaxKMeans
from consensus_clustering_tpu.serve import preflight as jax_preflight
from consensus_clustering_tpu_torch import ConsensusClustering
from consensus_clustering_tpu_torch.config import SweepConfig
from consensus_clustering_tpu_torch.convert import (
    config_from_jax,
    pair_state_from_jax,
)
from consensus_clustering_tpu_torch.data import make_blobs
from consensus_clustering_tpu_torch.estimator import bounds
from consensus_clustering_tpu_torch.estimator.engine import (
    PairConsensusEngine,
    verify_pair_state_frame,
)
from consensus_clustering_tpu_torch.estimator.sampler import (
    pair_key,
    sample_pairs,
)
from consensus_clustering_tpu_torch.estimator.tiled import (
    collect_resample_labels,
    exact_curves_for_k,
    tiled_exact_curves,
)
from consensus_clustering_tpu_torch.parallel.mesh import resample_mesh
from consensus_clustering_tpu_torch.models.kmeans import KMeans
from consensus_clustering_tpu_torch.parallel.streaming import StreamingSweep
from consensus_clustering_tpu_torch.parallel.sweep import run_sweep
from consensus_clustering_tpu_torch.resilience import (
    InjectedFault,
    IntegrityError,
    StreamCheckpointer,
    faults,
)
from consensus_clustering_tpu_torch.resilience.blocks import decode_frame
from consensus_clustering_tpu_torch.serve import preflight
from consensus_clustering_tpu_torch.utils.checkpoint import (
    estimator_stream_fingerprint,
    stream_fingerprint,
)

N, D, H, KS, SEED = 120, 4, 32, (2, 3, 4), 7


@pytest.fixture(scope="module")
def data():
    x, _ = make_blobs(n_samples=N, n_features=D, centers=3,
                      cluster_std=0.6, random_state=1)
    return x.astype(np.float32)


def _config(**kw):
    base = dict(n_samples=N, n_features=D, k_values=KS, n_iterations=H,
                store_matrices=False, stream_h_block=8)
    base.update(kw)
    return SweepConfig(**base)


@pytest.fixture(scope="module")
def dense(data):
    config = SweepConfig(n_samples=N, n_features=D, k_values=KS,
                         n_iterations=H, store_matrices=True)
    return run_sweep(KMeans(n_init=2), config, data, SEED, device="cpu")


@pytest.fixture(scope="module")
def estimates(data):
    return {path: PairConsensusEngine(
        KMeans(n_init=2), _config(accum_repr=path), device="cpu").run(
            data, SEED, H, return_state=True)
        for path in ("dense", "packed")}


# -- sampler and bounds -------------------------------------------------


@pytest.mark.parametrize("n", [2, 29, 5000, 100_000])
@pytest.mark.parametrize("m", [1, 1000, 2**17])
def test_sample_pairs_equal_jax(n, m):
    want = jax_sample_pairs(jax_pair_key(23), n, m)
    got = sample_pairs(pair_key(23), n, m)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert bool((got[0] < got[1]).all())


def test_pair_key_equals_jax():
    for seed in (0, 23, 2**31 - 1):
        np.testing.assert_array_equal(
            pair_key(seed).numpy(),
            np.asarray(jax.random.key_data(jax_pair_key(seed))))
    with pytest.raises(ValueError):
        sample_pairs(pair_key(0), 1, 4)
    with pytest.raises(ValueError):
        sample_pairs(pair_key(0), 4, 0)


@pytest.mark.parametrize("m,n,parity,delta", [
    (1, 2, True, 1e-3), (4096, 240, True, 1e-3), (2**17, 100_000, True, 0.05),
    (8192, 420, False, 1e-3), (10**6, 10**7, False, 0.2)])
def test_bounds_equal_reference(m, n, parity, delta):
    assert bounds.DEFAULT_DELTA == jax_bounds.DEFAULT_DELTA
    assert bounds.DEFAULT_MAX_PAIRS == jax_bounds.DEFAULT_MAX_PAIRS
    assert bounds.default_n_pairs(n) == jax_bounds.default_n_pairs(n)
    assert bounds.dkw_epsilon(m, delta) == jax_bounds.dkw_epsilon(m, delta)
    assert bounds.pair_cdf_scale(n, parity) == jax_bounds.pair_cdf_scale(
        n, parity)
    assert bounds.cdf_error_bound(m, n, parity, delta) == \
        jax_bounds.cdf_error_bound(m, n, parity, delta)
    assert bounds.pac_error_bound(m, n, parity, delta) == \
        jax_bounds.pac_error_bound(m, n, parity, delta)
    assert bounds.bound_disclosure(m, n, parity, delta) == \
        jax_bounds.bound_disclosure(m, n, parity, delta)


def test_preflight_models_equal_reference(monkeypatch):
    for args in [(100_000, 50, range(2, 21)), (300, 8, (2, 3))]:
        for kw in [{}, dict(h_block=100, checkpoints=False),
                   dict(dtype="float64", subsampling=0.5)]:
            assert preflight.estimate_job_bytes(*args, **kw) == \
                jax_preflight.estimate_job_bytes(*args, **kw)
            for repr_ in ("dense", "packed"):
                assert preflight.estimate_estimator_bytes(
                    *args, accum_repr=repr_, **kw) == \
                    jax_preflight.estimate_estimator_bytes(
                        *args, accum_repr=repr_, **kw)
    monkeypatch.delenv("CCTPU_MEMORY_BUDGET", raising=False)
    assert preflight.resolve_memory_budget(123) == 123
    assert preflight.resolve_memory_budget(0) is None
    assert preflight.resolve_memory_budget(device="cpu") > 2**30
    monkeypatch.setenv("CCTPU_MEMORY_BUDGET", "4096")
    assert preflight.resolve_memory_budget(device="cuda") == 4096
    monkeypatch.delenv("CCTPU_MEMORY_BUDGET")

    def no_card(*_):
        raise RuntimeError("no CUDA device")

    # On a CUDA device the budget is the card's memory, never host RAM: a
    # failed query raises.
    monkeypatch.setattr(torch.cuda, "get_device_properties", no_card)
    with pytest.raises(RuntimeError, match="no CUDA"):
        preflight.resolve_memory_budget(device="cuda")


# -- the engine -----------------------------------------------------------


@pytest.mark.parametrize("path", ["dense", "packed"])
def test_pair_counts_equal_dense_entries(dense, estimates, path):
    ps = estimates[path]["pair_state"]
    pi, pj = ps["pair_i"], ps["pair_j"]
    assert ps["mij"].shape == (len(KS), bounds.default_n_pairs(N))
    np.testing.assert_array_equal(ps["iij"], dense["iij"][pi, pj])
    np.testing.assert_array_equal(
        ps["mij"], np.stack([m[pi, pj] for m in dense["mij"]]))
    assert (ps["iij"] > 0).any() and (ps["mij"] > 0).any()


def test_paths_agree_and_bound_covers_error(dense, estimates):
    for name in ("hist", "cdf", "pac_area"):
        np.testing.assert_array_equal(estimates["dense"][name],
                                      estimates["packed"][name])
    out = estimates["packed"]
    disclosure = out["estimator"]
    assert disclosure == bounds.bound_disclosure(bounds.default_n_pairs(N),
                                                 N)
    err = np.abs(out["pac_area"].astype(np.float64)
                 - dense["pac_area"].astype(np.float64))
    assert (err <= disclosure["pac_error_bound"]).all(), err
    cdf_err = np.abs(out["cdf"].astype(np.float64)
                     - dense["cdf"].astype(np.float64)).max(-1)
    assert (cdf_err <= disclosure["cdf_error_bound"]).all(), cdf_err
    assert out["streaming"]["h_effective"] == H
    assert out["streaming"]["n_blocks_run"] == H // 8


def test_against_reference_engine(data, estimates):  # jaxlint: disable=JL018 -- CPU port and reference, N=120, H=32
    """The reference's engine on the same inputs: the plan and the pairs
    are shared bit for bit, so Iij at every pair is equal; on separated
    blobs the labels partition alike, so Mij is equal too; PAC banded."""
    jcfg = JaxSweepConfig(n_samples=N, n_features=D, k_values=KS,
                          n_iterations=H, store_matrices=False,
                          stream_h_block=8, accum_repr="packed")
    assert config_from_jax(dataclasses.asdict(jcfg)) == _config(
        accum_repr="packed")
    ref = JaxPairConsensusEngine(JaxKMeans(n_init=2), jcfg).run(
        data, SEED, H, return_state=True)
    state = pair_state_from_jax(ref["pair_state"])
    ours = estimates["packed"]
    ps = ours["pair_state"]
    np.testing.assert_array_equal(ref["pair_state"]["pair_i"], ps["pair_i"])
    np.testing.assert_array_equal(ref["pair_state"]["pair_j"], ps["pair_j"])
    np.testing.assert_array_equal(state["iij"].numpy(), ps["iij"])
    np.testing.assert_array_equal(state["mij"].numpy(), ps["mij"])
    pac, ref_pac = ours["pac_area"], np.asarray(ref["pac_area"])
    assert (np.abs(pac - ref_pac) <= np.maximum(0.02, 0.25 * ref_pac)).all()
    assert ours["estimator"] == ref["estimator"]
    assert set(ref["streaming"]) <= set(ours["streaming"])


def test_block_start_fault_resumes_bit_for_bit(tmp_path, data, estimates):  # jaxlint: disable=JL018 -- CPU port only, N=120, H=32
    ring = StreamCheckpointer(str(tmp_path))
    engine = PairConsensusEngine(KMeans(n_init=2),
                                 _config(accum_repr="packed"), device="cpu")
    faults.configure("block_start=2")
    try:
        with pytest.raises(InjectedFault):
            engine.run(data, SEED, H, checkpointer=ring)
    finally:
        faults.clear()
    out = engine.run(data, SEED, H, checkpointer=ring, return_state=True)
    ring.close()
    want = estimates["packed"]
    assert out["streaming"]["resumed_from_block"] == 2
    assert out["streaming"]["checkpoint_writes"] == 2
    for name in ("mij", "iij"):
        np.testing.assert_array_equal(out["pair_state"][name],
                                      want["pair_state"][name])
    for name in ("hist", "cdf", "pac_area"):
        np.testing.assert_array_equal(out[name], want[name])
    assert out["streaming"]["pac_trajectory"] == \
        want["streaming"]["pac_trajectory"]


def test_flipped_bit_fails_verify(tmp_path, data):  # jaxlint: disable=JL018 -- CPU port only, N=120, H=16
    ring = StreamCheckpointer(str(tmp_path))
    config = _config(n_iterations=16, k_values=(2, 3))
    PairConsensusEngine(KMeans(n_init=2), config, n_pairs=300,
                        device="cpu").run(data, SEED, 16, checkpointer=ring)
    ring.close()
    with open(tmp_path / "gen-00000001.ckpt", "rb") as f:
        header, arrays = decode_frame(f.read())
    assert verify_pair_state_frame(header, arrays) is None
    bad = dict(arrays)
    bad["state_mij"] = arrays["state_mij"].copy()
    bad["state_mij"].reshape(-1)[5] ^= 1
    assert "digest mismatch" in verify_pair_state_frame(header, bad)
    lying = {k: v for k, v in header.items() if k != "digest"}
    bad["state_mij"].reshape(-1)[5] = 10**6
    assert "outside [0, iij]" in verify_pair_state_frame(lying, bad)
    over = dict(arrays)
    over["state_iij"] = arrays["state_iij"] + 100
    assert "outside [0, h_done]" in verify_pair_state_frame(lying, over)


def test_streamed_sweep_frame_refused(tmp_path, data):  # jaxlint: disable=JL018 -- CPU port only, N=120, H=16
    """A streamed-sweep frame in the same ring is never resumed: other
    scheme, other fingerprint, other shapes."""
    ring = StreamCheckpointer(str(tmp_path))
    config = _config(n_iterations=16, k_values=(2, 3))
    StreamingSweep(KMeans(n_init=2), config, device="cpu").run(
        data, SEED, 16, checkpointer=ring)
    ring.flush()
    with open(tmp_path / "gen-00000001.ckpt", "rb") as f:
        header, arrays = decode_frame(f.read())
    engine = PairConsensusEngine(KMeans(n_init=2), config, n_pairs=300,
                                 device="cpu")
    assert "not a" in engine._verify_frame(header, arrays)
    out = engine.run(data, SEED, 16, checkpointer=ring)
    ring.close()
    assert out["streaming"]["resumed_from_block"] == 0
    assert any("stale fingerprint" in reason for _, reason in ring.skipped)
    fp = dict(config=config, seed=SEED, data_sha="x", backend="torch-cpu")
    est = estimator_stream_fingerprint(**fp, n_pairs=300)
    assert est != stream_fingerprint(**fp)
    assert est != estimator_stream_fingerprint(**fp, n_pairs=301)
    assert est != estimator_stream_fingerprint(
        **dict(fp, backend="torch-cuda"), n_pairs=300)


def test_sentinel_catches_accumulator_bitflip(data):  # jaxlint: disable=JL018 -- CPU port only, N=120, H=16
    engine = PairConsensusEngine(KMeans(n_init=2),
                                 _config(n_iterations=16, k_values=(2, 3)),
                                 n_pairs=300, device="cpu")
    faults.configure("accumulator=1:bitflip")
    try:
        with pytest.raises(IntegrityError) as e:
            engine.run(data, SEED, 16, integrity_check_every=1)
    finally:
        faults.clear()
    assert e.value.integrity_checks_run == 2
    clean = engine.run(data, SEED, 16, integrity_check_every=1)
    assert clean["streaming"]["integrity_checks"] == 2


def test_adaptive_stop_and_validation(data):  # jaxlint: disable=JL018 -- CPU port only, N=120, H=32
    engine = PairConsensusEngine(KMeans(n_init=2), _config(), n_pairs=500,
                                 device="cpu")
    out = engine.run(data, SEED, H, adaptive_tol=1.0, adaptive_patience=1)
    assert out["streaming"]["stopped_early"]
    assert out["streaming"]["h_effective"] == 16
    with pytest.raises(ValueError, match="stream_h_block"):
        PairConsensusEngine(KMeans(), _config(stream_h_block=None),
                            device="cpu")
    with pytest.raises(ValueError, match="store_matrices"):
        PairConsensusEngine(KMeans(), _config(store_matrices=True),
                            device="cpu")
    with pytest.raises(ValueError, match="'h'/'n'"):
        PairConsensusEngine(KMeans(), _config(), mesh=resample_mesh(
            ["cpu"] * 2, k_shards=2))


# -- tiled exact curves ---------------------------------------------------


@pytest.mark.parametrize("tile_rows,parity", [(2048, True), (16, True),
                                              (37, False), (1, True)])
def test_tiled_equals_reference_numpy(tile_rows, parity):
    rng = np.random.default_rng(tile_rows)
    n, h, n_sub = 97, 21, 77
    idx = np.stack([rng.permutation(n)[:n_sub] for _ in range(h)])
    lab = rng.integers(0, 5, size=(h, n_sub))
    idx[-1, :10] = -1  # dropped entries
    want = jax_tiled_exact_curves(idx, lab, n, 20, 2, 18,
                                  parity_zeros=parity, tile_rows=tile_rows)
    tiles = []
    got = tiled_exact_curves(idx, lab, n, 20, 2, 18, parity_zeros=parity,
                             tile_rows=tile_rows, device="cpu",
                             tile_callback=lambda t, r: tiles.append(r))
    for name in ("hist", "cdf", "pac_area"):
        np.testing.assert_array_equal(
            np.asarray(got[name]).view(np.uint32),
            np.asarray(want[name], np.float32).view(np.uint32))
    assert tiles[-1] == n and len(tiles) == -(-n // tile_rows)
    with pytest.raises(ValueError):
        tiled_exact_curves(idx, lab, n, 20, 2, 18, tile_rows=0,
                           device="cpu")


def test_exact_curves_for_k_equals_dense_sweep(data, dense):
    out = exact_curves_for_k(KMeans(n_init=2), _config(), data, SEED, 3,
                             tile_rows=50, device="cpu")
    for name in ("hist", "cdf", "pac_area"):
        np.testing.assert_array_equal(out[name], dense[name][1])
    assert out["timing"]["device_memory"] == {}
    idx, _ = collect_resample_labels(KMeans(n_init=2), _config(), data,
                                     SEED, 3, device="cpu")
    jcfg = JaxSweepConfig(n_samples=N, n_features=D, k_values=KS,
                          n_iterations=H, store_matrices=False,
                          stream_h_block=8)
    jidx, _ = jax_collect_resample_labels(JaxKMeans(n_init=2), jcfg, data,
                                          SEED, 3)
    np.testing.assert_array_equal(idx.numpy(), jidx)


# -- the API --------------------------------------------------------------


def _fit(x, **kw):
    args = dict(K_range=KS, n_iterations=H, random_state=SEED,
                clusterer_options={"n_init": 2}, stream_h_block=8)
    args.update(kw)
    return ConsensusClustering(device="cpu", **args, plot_cdf=False).fit(x)


def test_estimate_mode_fills_reference_keys(data):  # jaxlint: disable=JL018 -- CPU port and reference, N=120, H=32
    from consensus_clustering_tpu import ConsensusClustering as JaxCC

    ref = JaxCC(K_range=KS, n_iterations=H, random_state=SEED,
                clusterer_options={"n_init": 2}, stream_h_block=8,
                plot_cdf=False, mode="estimate", n_pairs=4000).fit(data)
    ours = _fit(data, mode="estimate", n_pairs=4000)
    assert ours.metrics_["mode"] == "estimate"
    assert ours.metrics_["estimator"] == ref.metrics_["estimator"]
    for key in ("mode", "estimator", "streaming", "run_seconds",
                "compile_seconds", "resamples_per_second"):
        assert key in ours.metrics_, key
    for k in KS:
        assert set(ours.cdf_at_K_data[k]) == set(ref.cdf_at_K_data[k])
        assert ours.cdf_at_K_data[k]["mij"] is None
        a = ours.cdf_at_K_data[k]["pac_area"]
        b = ref.cdf_at_K_data[k]["pac_area"]
        assert abs(a - b) <= max(0.02, 0.25 * b)
    assert ours.best_k_ == ref.best_k_


def test_auto_follows_the_budget(data, monkeypatch):  # jaxlint: disable=JL018 -- CPU port only, N=120, H=32
    monkeypatch.setenv("CCTPU_MEMORY_BUDGET", "1000")
    small = _fit(data, mode="auto")
    assert small.metrics_["mode"] == "estimate"
    assert small.metrics_["auto"]["budget_bytes"] == 1000
    assert small.metrics_["auto"]["dense_total_bytes"] > 1000
    monkeypatch.setenv("CCTPU_MEMORY_BUDGET", str(10**12))
    large = _fit(data, mode="auto")
    assert "mode" not in large.metrics_ and "estimator" not in large.metrics_
    # Where the estimator cannot run, auto attempts exact.
    monkeypatch.setenv("CCTPU_MEMORY_BUDGET", "1000")
    matrices = _fit(data, mode="auto", store_matrices=True)
    assert matrices.cdf_at_K_data[2]["mij"] is not None


def test_exact_best_k_refines_at_h_effective(data, dense):  # jaxlint: disable=JL018 -- CPU port only, N=120, H=32
    full = _fit(data, mode="estimate", exact_best_k=True)
    k = full.best_k_
    info = full.metrics_["exact_best_k"]
    assert info["k"] == k
    entry = full.cdf_at_K_data[k]
    assert entry["pac_area"] == info["pac_area_exact"]
    i = KS.index(k)
    np.testing.assert_array_equal(entry["cdf"], dense["cdf"][i])
    assert entry["pac_area"] == float(dense["pac_area"][i])
    stopped = _fit(data, mode="estimate", exact_best_k=True,
                   adaptive_tol=1.0, adaptive_patience=1)
    h_eff = stopped.metrics_["streaming"]["h_effective"]
    assert h_eff < H
    want = exact_curves_for_k(KMeans(n_init=2), _config(n_iterations=h_eff),
                              data, SEED, stopped.best_k_, device="cpu")
    assert stopped.cdf_at_K_data[stopped.best_k_]["pac_area"] == \
        float(want["pac_area"])


def test_estimate_mode_value_errors(data):  # jaxlint: disable=JL018 -- raises before any sweep
    from sklearn.cluster import KMeans as SkKMeans

    with pytest.raises(ValueError, match="store_matrices"):
        _fit(data, mode="estimate", store_matrices=True)
    with pytest.raises(ValueError, match="consensus"):
        _fit(data, mode="estimate", compute_consensus_labels=True)
    with pytest.raises(ValueError, match="host-backend"):
        _fit(data, mode="estimate", clusterer=SkKMeans(n_init=1),
             clusterer_options={})
    with pytest.raises(ValueError, match="only applies"):
        ConsensusClustering(n_pairs=100, plot_cdf=False)
    for bad in (0, -3, True, 2.5):
        with pytest.raises(ValueError, match="n_pairs"):
            ConsensusClustering(mode="estimate", n_pairs=bad, plot_cdf=False)
    with pytest.raises(ValueError, match="mode must be"):
        ConsensusClustering(mode="fast", plot_cdf=False)
    with pytest.raises(ValueError, match="serving mode"):
        ConsensusClustering(mode="progressive", plot_cdf=False)
