"""The port's streaming engine against its monolithic sweep and against the
reference package's ``StreamingSweep``.

- Streamed full H equals the port's monolithic sweep bit for bit (Mij,
  Iij, Cij, hist, cdf, pac_area), dense and packed, fused and unfused,
  over block sizes that do and do not divide H and with cluster_batch.
- Against the reference's packed engine on well-separated blobs: Iij and
  the co-sample planes bit-identical, PAC within 0.02 per K, and the
  captured K=3 cluster planes bit-identical.
- One engine serves any H below its packed capacity; the capacity raises.
- The early-stop rule decides as the reference's driver does on synthetic
  PAC trajectories, and an adaptive run gives the reference's h_effective.
- fuse_block resolution, validation, and the features left for later.
"""

import dataclasses

import numpy as np
import pytest
import torch

from consensus_clustering_tpu.config import SweepConfig as JaxSweepConfig
from consensus_clustering_tpu.models.kmeans import KMeans as JaxKMeans
from consensus_clustering_tpu.parallel.streaming import (
    StreamingSweep as JaxStreamingSweep,
    run_streaming_sweep as jax_run_streaming_sweep,
)
from consensus_clustering_tpu_torch import ConsensusClustering
from consensus_clustering_tpu_torch.config import SweepConfig
from consensus_clustering_tpu_torch.convert import (
    config_from_jax,
    kmeans_from_jax,
    planes_from_jax,
    state_from_jax,
)
from consensus_clustering_tpu_torch.data import make_blobs
from consensus_clustering_tpu_torch.models.kmeans import KMeans
from consensus_clustering_tpu_torch.parallel.streaming import (
    StreamingSweep,
    adaptive_decision,
    run_streaming_sweep,
)
from consensus_clustering_tpu_torch.parallel.sweep import run_sweep

_KEYS = ("mij", "iij", "cij", "hist", "cdf", "pac_area")


@pytest.fixture(scope="module")
def data():
    x, _ = make_blobs(n_samples=110, n_features=5, centers=4,
                      cluster_std=2.0, random_state=6)
    return x.astype(np.float32)


@pytest.fixture(scope="module")
def mono(data):
    config = SweepConfig(n_samples=110, n_features=5, k_values=(2, 3, 4, 5),
                         n_iterations=29, store_matrices=True)
    return config, run_sweep(KMeans(n_init=2), config, data, 9,
                             device="cpu")


@pytest.mark.parametrize(
    "accum_repr,fuse_block,h_block,cluster_batch",
    [("dense", "auto", 7, None), ("dense", "off", 29, 4),
     ("packed", "off", 8, None), ("packed", "on", 5, 3),
     ("packed", "auto", 32, None), ("packed", "auto", 1, None)],
)
def test_streamed_full_h_equals_monolithic(mono, data, accum_repr,  # jaxlint: disable=JL018 -- CPU port only, N=110, H=29
                                           fuse_block, h_block,
                                           cluster_batch):
    config, ref = mono
    out = run_streaming_sweep(
        KMeans(n_init=2),
        dataclasses.replace(config, stream_h_block=h_block,
                            accum_repr=accum_repr, fuse_block=fuse_block,
                            cluster_batch=cluster_batch),
        data, 9, device="cpu",
    )
    for name in _KEYS:
        np.testing.assert_array_equal(out[name], ref[name], err_msg=name)
    s = out["streaming"]
    n_blocks = -(-29 // h_block)
    assert (s["h_effective"], s["n_blocks_run"]) == (29, n_blocks)
    assert len(s["pac_trajectory"]) == n_blocks and not s["stopped_early"]
    np.testing.assert_array_equal(
        np.float32(s["pac_trajectory"][-1]), ref["pac_area"])
    timing = out["timing"]
    assert set(timing["kernel_launches"]) == {
        "hist", "lloyd", "popcount", "fused_block", "assign"}
    if accum_repr == "packed":
        assert timing["packed_kernel"] == "plain"
        assert timing["fuse_block"] == ("unfused" if fuse_block == "off"
                                        else "fused")
    else:
        assert "packed_kernel" not in timing


def test_packed_monolithic_sweep_equals_dense(mono, data):  # jaxlint: disable=JL018 -- CPU port only, N=110, H=29
    config, ref = mono
    out = run_sweep(KMeans(n_init=2),
                    dataclasses.replace(config, accum_repr="packed"),
                    data, 9, device="cpu")
    for name in _KEYS:
        np.testing.assert_array_equal(out[name], ref[name], err_msg=name)
    assert out["timing"]["packed_kernel"] == "plain"
    assert "packed_kernel" not in ref["timing"]


@pytest.fixture(scope="module")
def against_reference(blobs):
    x, _ = blobs
    jax_config = JaxSweepConfig(
        n_samples=120, n_features=5, k_values=(2, 3, 4), n_iterations=40,
        store_matrices=True, stream_h_block=16, accum_repr="packed",
    )
    jax_km = JaxKMeans(n_init=2)
    ref = JaxStreamingSweep(jax_km, jax_config).run(x, 23, 40,
                                                    capture_state=True)
    engine = StreamingSweep(kmeans_from_jax(dataclasses.asdict(jax_km)),
                            config_from_jax(dataclasses.asdict(jax_config)),
                            device="cpu")
    got = engine.run(x, 23, 40, capture_state=True)
    return ref, got, engine


def test_iij_and_coplanes_bit_identical_to_reference(against_reference):
    ref, got, engine = against_reference
    np.testing.assert_array_equal(got["iij"], ref["iij"])
    np.testing.assert_array_equal(
        got["final_state"]["coplanes"],
        ref["final_state"]["coplanes"].view(np.int32))
    assert got["timing"]["fuse_block"] == "fused"      # the port fuses
    assert ref["timing"]["fuse_block"] == "unfused"    # the reference's CPU
    assert np.abs(got["pac_area"] - ref["pac_area"]).max() <= 0.02
    assert got["streaming"]["n_blocks_run"] == ref["streaming"][
        "n_blocks_run"] == 3


def test_k3_planes_bit_identical_on_separated_blobs(against_reference):
    ref, got, _ = against_reference
    np.testing.assert_array_equal(
        got["final_state"]["planes"][1],
        ref["final_state"]["planes"][1].view(np.int32))
    np.testing.assert_array_equal(got["mij"][1], ref["mij"][1])


def test_state_from_reference_carries_bits(against_reference):
    ref, got, _ = against_reference
    state = state_from_jax(ref["final_state"])
    assert state["planes"].dtype == torch.int32
    np.testing.assert_array_equal(state["coplanes"].numpy(),
                                  got["final_state"]["coplanes"])
    words = np.array([[0, 2**31, 2**32 - 1]], dtype=np.uint32)
    np.testing.assert_array_equal(planes_from_jax(words).numpy(),
                                  [[0, -2**31, -1]])
    dense = state_from_jax({"iij": ref["iij"]})
    np.testing.assert_array_equal(dense["iij"].numpy(), ref["iij"])
    with pytest.raises(ValueError, match="uint32"):
        planes_from_jax(np.zeros(3, np.int64))


def test_one_engine_serves_any_h_below_capacity(data):  # jaxlint: disable=JL018 -- CPU port only, N=110
    config = SweepConfig(n_samples=110, n_features=5, k_values=(2, 3),
                         n_iterations=29, store_matrices=False,
                         stream_h_block=8, accum_repr="packed")
    engine = StreamingSweep(KMeans(n_init=2), config, device="cpu")
    short = engine.run(data, 4, 13)
    full = engine.run(data, 4, 32)  # the capacity: 4 blocks of 8
    assert short["streaming"]["h_effective"] == 13
    assert full["streaming"]["h_effective"] == 32
    mono = run_sweep(KMeans(n_init=2),
                     dataclasses.replace(config, n_iterations=13,
                                         stream_h_block=None),
                     data, 4, device="cpu")
    np.testing.assert_array_equal(short["pac_area"], mono["pac_area"])
    with pytest.raises(ValueError, match="capacity is 32"):
        engine.run(data, 4, 33)


def _trajectory(seed, n_blocks):
    rs = np.random.default_rng(seed)
    steps = rs.normal(size=(n_blocks, 2)) * 0.05 * 0.6 ** np.arange(
        n_blocks)[:, None]
    return (0.3 + np.cumsum(steps, axis=0)).astype(np.float32)


def _drive_reference(traj, h_block, n_iter, tol, patience, min_h):
    """The reference driver's real stop rule, run over a stub block step
    that returns the synthetic curves."""
    config = JaxSweepConfig(n_samples=8, n_features=2, k_values=(2, 3),
                            n_iterations=n_iter, store_matrices=False,
                            stream_h_block=h_block)
    engine = JaxStreamingSweep(JaxKMeans(), config)
    zeros = np.zeros((2, 20), np.float32)
    engine.init_state = lambda: {}
    engine._step = lambda state, x, key, h_start, h_total: (state, {
        "hist": zeros, "cdf": zeros,
        "pac_area": traj[int(h_start) // h_block]})
    return engine.run(np.zeros((8, 2), np.float32), 0, n_iter,
                      adaptive_tol=tol, adaptive_patience=patience,
                      adaptive_min_h=min_h)["streaming"]


def _drive_port(traj, h_block, n_iter, tol, patience, min_h):
    """The port's driver over the same stub block step."""
    config = SweepConfig(n_samples=8, n_features=2, k_values=(2, 3),
                         n_iterations=n_iter, store_matrices=False,
                         stream_h_block=h_block)
    engine = StreamingSweep(KMeans(), config, device="cpu")
    zeros = torch.zeros((2, 20))
    engine.init_state = lambda: {}
    engine.step = lambda state, x, key, h_start, h_total, x_cols=None: {
        "hist": zeros, "cdf": zeros,
        "pac_area": torch.tensor(traj[h_start // h_block])}
    return engine.run(np.zeros((8, 2), np.float32), 0, n_iter,
                      adaptive_tol=tol, adaptive_patience=patience,
                      adaptive_min_h=min_h)["streaming"]


@pytest.mark.parametrize(
    "seed,tol,patience,min_h",
    [(0, 0.01, 2, 0), (1, 0.01, 1, 30), (2, 0.002, 2, 0), (3, 1e-6, 2, 0),
     (4, 10.0, 3, 0), (5, 10.0, 1, 45), (6, 0.005, 4, 10)],
)
def test_stop_rule_decides_as_the_reference(seed, tol, patience, min_h):
    traj = _trajectory(seed, 10)
    args = (traj, 5, 47, tol, patience, min_h)
    ref, got = _drive_reference(*args), _drive_port(*args)
    keys = ("h_effective", "n_blocks_run", "stopped_early", "pac_trajectory")
    assert {k: got[k] for k in keys} == {k: ref[k] for k in keys}


def test_adaptive_decision_rule():
    pac = np.float32([0.2, 0.1])
    assert adaptive_decision(None, pac, 0, 0.01, 1, 0, 5, 50) == (0, False)
    assert adaptive_decision(pac, pac + 0.001, 0, 0.01, 1, 0, 5, 50) == (
        1, True)
    assert adaptive_decision(pac, pac + 0.001, 0, 0.01, 1, 10, 5, 50) == (
        1, False)   # below min_h
    assert adaptive_decision(pac, pac + 0.001, 3, 0.01, 1, 0, 50, 50) == (
        4, False)   # nothing left to save
    assert adaptive_decision(pac, pac + 0.5, 3, 0.01, 1, 0, 5, 50) == (
        0, False)


def test_adaptive_fit_gives_reference_h_effective():  # jaxlint: disable=JL018 -- N=60, H=60: a few seconds
    rs = np.random.default_rng(0)
    x = np.concatenate([rs.normal(0.0, 0.2, (30, 4)),
                        rs.normal(5.0, 0.2, (30, 4))]).astype(np.float32)
    jax_config = JaxSweepConfig(
        n_samples=60, n_features=4, k_values=(2, 3), n_iterations=60,
        store_matrices=False, stream_h_block=5, adaptive_tol=0.02,
        adaptive_patience=2, adaptive_min_h=10,
    )
    ref = jax_run_streaming_sweep(JaxKMeans(n_init=2), jax_config, x, 11)
    cc = ConsensusClustering(
        K_range=(2, 3), n_iterations=60, random_state=11, device="cpu",
        stream_h_block=5, accum_repr="packed", adaptive_tol=0.02,
        adaptive_patience=2, adaptive_min_h=10, clusterer_options={
            "n_init": 2}, plot_cdf=False,
    ).fit(x)
    s = cc.metrics_["streaming"]
    assert s["stopped_early"] and ref["streaming"]["stopped_early"]
    assert s["h_effective"] == ref["streaming"]["h_effective"] < 60
    assert cc.cdf_at_K_data[2]["mij"] is None  # 'auto' keeps no matrices
    assert cc.metrics_["timing"]["fuse_block"] == "fused"


def test_api_stream_fit_matches_monolithic_fit(data):  # jaxlint: disable=JL018 -- CPU port only, N=110
    kwargs = dict(K_range=range(2, 5), n_iterations=20, random_state=0,
                  device="cpu")
    mono = ConsensusClustering(**kwargs, plot_cdf=False).fit(data)
    stream = ConsensusClustering(**kwargs, stream_h_block=6,
                                 accum_repr="packed", plot_cdf=False).fit(data)
    for k in range(2, 5):
        for name in ("mij", "iij", "cij", "hist", "cdf"):
            np.testing.assert_array_equal(stream.cdf_at_K_data[k][name],
                                          mono.cdf_at_K_data[k][name])
    assert stream.best_k_ == mono.best_k_
    assert stream.metrics_["streaming"]["n_blocks_run"] == 4
    assert stream.metrics_["timing"] == {
        "packed_kernel": "plain", "fuse_block": "fused",
        "fused_kernel": "plain"}
    assert "streaming" not in mono.metrics_


@pytest.mark.parametrize(
    "fuse,dtype,expect",
    [("auto", "float32", "fused"), ("auto", "float64", "unfused"),
     ("off", "float32", "unfused"), ("on", "float32", "fused")],
)
def test_fuse_block_resolution(fuse, dtype, expect):
    config = SweepConfig(n_samples=20, n_features=2, n_iterations=8,
                         stream_h_block=4, accum_repr="packed",
                         fuse_block=fuse, dtype=dtype)
    engine = StreamingSweep(KMeans(), config, device="cpu")
    assert (engine.packed_kernel, engine.fuse_block) == ("plain", expect)
    assert engine.fused_kernel == ("plain" if expect == "fused" else None)


def test_config_and_engine_validation():  # jaxlint: disable=JL018 -- every fit here raises before any sweep
    base = dict(n_samples=20, n_features=2, n_iterations=8)

    class NoFuse(KMeans):
        supports_fused_assign = False

    on = SweepConfig(**base, stream_h_block=4, accum_repr="packed",
                     fuse_block="on")
    with pytest.raises(ValueError, match="supports_fused_assign"):
        StreamingSweep(NoFuse(), on, device="cpu")
    assert StreamingSweep(NoFuse(), dataclasses.replace(
        on, fuse_block="auto"), device="cpu").fuse_block == "unfused"
    for bad, match in (
        (dict(fuse_block="yes"), "fuse_block"),
        (dict(fuse_block="on"), "accum_repr"),
        (dict(fuse_block="on", accum_repr="packed", dtype="float64"),
         "float32"),
        (dict(accum_repr="sparse"), "accum_repr"),
        (dict(use_packed_kernel=False), "use_packed_kernel"),
        (dict(stream_h_block=0), "stream_h_block"),
        (dict(adaptive_tol=0.01, store_matrices=False), "stream_h_block"),
        (dict(adaptive_tol=0.01, stream_h_block=4), "store_matrices"),
        (dict(adaptive_patience=0), "adaptive_patience"),
    ):
        with pytest.raises(ValueError, match=match):
            SweepConfig(**base, **bad)
    with pytest.raises(ValueError, match="stream_h_block"):
        StreamingSweep(KMeans(), SweepConfig(**base), device="cpu")
    with pytest.raises(ValueError, match="use_packed_kernel"):
        ConsensusClustering(K_range=(2, 3), random_state=0, device="cpu",
                            use_packed_kernel=False,
                            plot_cdf=False).fit(np.eye(6))
    with pytest.raises(ValueError, match="fuse_block"):
        ConsensusClustering(fuse_block="maybe", plot_cdf=False)


def _two_process_mesh():
    """A (1, 2, 1) mesh whose 'h' shards belong to ranks 0 and 1."""
    from consensus_clustering_tpu_torch.parallel.mesh import Mesh

    devices = np.empty(2, dtype=object)
    devices[:] = [torch.device("cpu")] * 2
    return Mesh(devices.reshape(1, 2, 1), np.arange(2).reshape(1, 2, 1))


def test_features_left_for_later_raise():  # jaxlint: disable=JL018 -- every run here raises before any block
    config = SweepConfig(n_samples=20, n_features=2, n_iterations=8,
                         store_matrices=False, stream_h_block=4)
    engine = StreamingSweep(KMeans(), config, device="cpu")
    x = np.zeros((20, 2), np.float32)
    # A mesh across processes builds (its merges run only in a group).
    across = StreamingSweep(KMeans(), config, mesh=_two_process_mesh())
    assert across.mesh.process_count == 2
    assert across._owners() == {(0, 0): (0, 0, 0)}
    # run_fused is ported (the serve batch axis): one job is not a batch.
    with pytest.raises(ValueError, match=">= 2 jobs"):
        engine.run_fused([x], [0], 8)
    with pytest.raises(ValueError, match="capture_state"):
        engine.run(x, 0, 8, capture_state=True)
