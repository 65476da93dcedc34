"""The port's ('k', 'h', 'n') mesh on the CPU (a virtual mesh: ``["cpu"] * D``).

- ``sweep_geometry`` equals the reference's field by field over a table of
  (N, H, K list, mesh, ``k_interleave``): pure integers.
- Mesh invariance, bit for bit: Mij, Iij, Cij, hist, cdf and pac_area of
  the monolithic sweep (dense, packed), the stream (dense, packed unfused,
  packed fused) and the estimator's curves and pair counts on every mesh
  equal the one-device port's.
- Against the reference's sharded sweep on its 8 virtual devices: Iij bit
  for bit, Mij bit for bit on separated blobs at K = the blob count, PAC in
  the band of ``tests/test_torch_sweep.py``.
- Frames written under one mesh resume under another with the same padded
  block, bit for bit (stream and estimator); another padded block is
  refused.
- Refusals and the surfaces: indivisible shards, a 'k' mesh to the
  estimator (``mode="auto"`` then runs exact), ``run --row-shards 2
  --device cpu`` equal to the API fit, and the scheduler's device count in
  the 413 disclosure.
"""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

from consensus_clustering_tpu.config import SweepConfig as JaxSweepConfig
from consensus_clustering_tpu.models.kmeans import KMeans as JaxKMeans
from consensus_clustering_tpu.parallel.mesh import (
    resample_mesh as jax_resample_mesh,
)
from consensus_clustering_tpu.parallel.sweep import (
    run_sweep as jax_run_sweep,
    sweep_geometry as jax_sweep_geometry,
)
from consensus_clustering_tpu_torch import ConsensusClustering
from consensus_clustering_tpu_torch.config import SweepConfig
from consensus_clustering_tpu_torch.convert import config_from_jax
from consensus_clustering_tpu_torch.data import make_blobs
from consensus_clustering_tpu_torch.estimator.engine import (
    PairConsensusEngine,
)
from consensus_clustering_tpu_torch.models.kmeans import KMeans
from consensus_clustering_tpu_torch.parallel import resample_mesh
from consensus_clustering_tpu_torch.parallel.streaming import (
    StreamingSweep,
    run_streaming_sweep,
)
from consensus_clustering_tpu_torch.parallel.sweep import (
    run_sweep,
    sweep_geometry,
)
from consensus_clustering_tpu_torch.resilience import InjectedFault, faults
from consensus_clustering_tpu_torch.resilience.blocks import (
    StreamCheckpointer,
)

N, H, KS, SEED = 61, 21, (2, 3, 4), 5
MATS = ("mij", "iij", "cij", "hist", "cdf", "pac_area")
CURVES = ("hist", "cdf", "pac_area")


def _mesh(k, h, n):
    return resample_mesh(["cpu"] * (k * h * n), row_shards=n, k_shards=k)


@pytest.fixture(scope="module")
def data():
    x, _ = make_blobs(n_samples=N, n_features=3, centers=3,
                      cluster_std=1.5, random_state=2)
    return x.astype(np.float32)


def _config(**kw):
    base = dict(n_samples=N, n_features=3, k_values=KS, n_iterations=H,
                cluster_batch=4)
    base.update(kw)
    return SweepConfig(**base)


@pytest.fixture(scope="module")
def one_device(data):
    return run_sweep(KMeans(n_init=2), _config(), data, SEED, device="cpu")


def _equal(a, b, names):
    for name in names:
        np.testing.assert_array_equal(a[name], b[name], err_msg=name)
        assert a[name].dtype == b[name].dtype, name


# -- geometry --------------------------------------------------------------


@pytest.mark.parametrize("n,h_rows,ks,shape,interleave,batch", [
    (29, 30, (2, 3, 4, 5), (1, 8, 1), False, None),
    (120, 24, (2, 3, 4), (2, 2, 2), True, 4),
    (5000, 500, tuple(range(2, 21)), (2, 2, 2), True, 16),
    (5000, 100, tuple(range(2, 21)), (1, 1, 3), False, 16),
    (29, 30, (2, 3, 4), (8, 1, 1), False, None),
    (100, 17, (2, 3), (1, 2, 1), False, 8),
    (29, 13, (2, 3, 4, 5, 6, 7, 8), (4, 1, 2), True, 2),
    (7, 5, (2,), (1, 4, 2), False, None),
])
def test_sweep_geometry_equals_the_reference(n, h_rows, ks, shape,
                                             interleave, batch):
    k, h, r = shape
    jax_config = JaxSweepConfig(n_samples=n, n_features=2, k_values=ks,
                                n_iterations=h_rows, k_interleave=interleave,
                                cluster_batch=batch)
    devices = jax.devices()
    if k * h * r <= len(devices):
        jax_mesh = jax_resample_mesh(devices[:k * h * r], row_shards=r,
                                     k_shards=k)
    else:  # geometry reads only the axis sizes: repeat a device
        jax_mesh = JaxMesh(np.asarray([devices[0]] * (k * h * r),
                                      dtype=object).reshape(k, h, r),
                           ("k", "h", "n"))
    ref = jax_sweep_geometry(jax_config, jax_mesh, h_rows)
    got = sweep_geometry(config_from_jax(dataclasses.asdict(jax_config)),
                         _mesh(k, h, r), h_rows)
    for field in got._fields:
        want, have = getattr(ref, field), getattr(got, field)
        if field == "k_unperm":
            assert (want is None) == (have is None)
            if want is not None:
                np.testing.assert_array_equal(have, want)
        else:
            assert have == want, field
    assert list(got.k_values_pad) == np.asarray(ref.k_arr).tolist()


def test_cluster_batch_warning_names_the_shard(caplog):
    with caplog.at_level("WARNING"):
        sweep_geometry(_config(cluster_batch=8), _mesh(1, 2, 1), 16)
    assert "cluster_batch=8 >= the per-device resample shard (8 of 16" \
        in caplog.text


def test_mesh_shapes_and_refusals():  # jaxlint: disable=JL018 -- raises before any sweep
    mesh = _mesh(2, 2, 2)
    assert mesh.shape == {"k": 2, "h": 2, "n": 2}
    assert mesh.axis_names == ("k", "h", "n")
    assert mesh.primary == torch.device("cpu")
    assert mesh.local_devices == [torch.device("cpu")]
    with pytest.raises(ValueError, match="not divisible"):
        resample_mesh(["cpu"] * 6, k_shards=4)
    with pytest.raises(ValueError, match="must be >= 1"):
        resample_mesh(["cpu"], row_shards=0)
    with pytest.raises(TypeError, match="Mesh"):
        ConsensusClustering(mesh=object(), plot_cdf=False)
    with pytest.raises(ValueError, match="primary device"):
        run_sweep(KMeans(), _config(), np.zeros((N, 3), np.float32), 0,
                  device="meta", mesh=mesh)


# -- mesh invariance, bit for bit -------------------------------------------

MESHES = [((1, 8, 1), False), ((1, 4, 2), False), ((2, 2, 2), False),
          ((2, 2, 2), True), ((8, 1, 1), False), ((1, 1, 3), False)]


@pytest.mark.parametrize("shape,interleave", MESHES)
@pytest.mark.parametrize("accum_repr", ["dense", "packed"])
def test_monolithic_sweep_is_mesh_invariant(data, one_device, shape,  # jaxlint: disable=JL018 -- CPU port only, N=61, H=21
                                            interleave, accum_repr):
    config = _config(k_interleave=interleave, accum_repr=accum_repr)
    got = run_sweep(KMeans(n_init=2), config, data, SEED, mesh=_mesh(*shape))
    _equal(got, one_device, MATS)
    assert got["timing"]["mesh"] == dict(zip("khn", shape))


STREAM_MESHES = [((1, 1, 1), False), ((1, 4, 2), False), ((2, 2, 2), True),
                 ((8, 1, 1), False), ((1, 1, 3), False)]


@pytest.mark.parametrize("shape,interleave", STREAM_MESHES)
@pytest.mark.parametrize("accum_repr,fuse", [("dense", "off"),
                                             ("packed", "off"),
                                             ("packed", "on")])
def test_stream_is_mesh_invariant(data, one_device, shape, interleave,  # jaxlint: disable=JL018 -- CPU port only, N=61, H=21
                                  accum_repr, fuse):
    config = _config(stream_h_block=8, accum_repr=accum_repr, fuse_block=fuse,
                     k_interleave=interleave)
    got = run_streaming_sweep(KMeans(n_init=2), config, data, SEED,
                              mesh=_mesh(*shape))
    _equal(got, one_device, MATS)
    assert got["timing"].get("fuse_block") == (
        None if accum_repr == "dense" else {"on": "fused",
                                            "off": "unfused"}[fuse])


def _estimator_config(accum_repr):
    return _config(stream_h_block=8, store_matrices=False,
                   accum_repr=accum_repr)


@pytest.fixture(scope="module")
def one_device_estimates(data):
    return {acc: PairConsensusEngine(
        KMeans(n_init=2), _estimator_config(acc), n_pairs=301,
        device="cpu").run(data, SEED, H, return_state=True)
        for acc in ("dense", "packed")}


@pytest.mark.parametrize("shape", [(1, 8, 1), (1, 4, 2), (1, 2, 2),
                                   (1, 1, 3)])
@pytest.mark.parametrize("accum_repr", ["dense", "packed"])
def test_estimator_is_mesh_invariant(data, one_device_estimates, shape,  # jaxlint: disable=JL018 -- CPU port only, N=61, H=21
                                     accum_repr):
    want = one_device_estimates[accum_repr]
    got = PairConsensusEngine(KMeans(n_init=2), _estimator_config(accum_repr),
                              n_pairs=301, mesh=_mesh(*shape)).run(
        data, SEED, H, return_state=True)
    _equal(got, want, CURVES)
    _equal(got["pair_state"], want["pair_state"],
           ("pair_i", "pair_j", "mij", "iij"))
    assert got["pair_state"]["mij"].shape == (len(KS), 301)


def test_api_fits_on_a_mesh_equal_one_device(data):  # jaxlint: disable=JL018 -- CPU port only, N=61, H=21
    kw = dict(K_range=KS, n_iterations=H, random_state=SEED, cluster_batch=4)
    one = ConsensusClustering(device="cpu", **kw, plot_cdf=False).fit(data)
    for extra in (dict(k_interleave=True, mesh=_mesh(2, 2, 2)),
                  dict(mesh=_mesh(1, 2, 2), stream_h_block=8,
                       accum_repr="packed")):
        fit = ConsensusClustering(**kw, **extra, plot_cdf=False).fit(data)
        for k in KS:
            for name in ("pac_area", "hist", "mij", "iij"):
                np.testing.assert_array_equal(fit.cdf_at_K_data[k][name],
                                              one.cdf_at_K_data[k][name])
        assert fit.best_k_ == one.best_k_


# -- against the reference's sharded sweep ----------------------------------


@pytest.mark.parametrize("shape", [(2, 2, 2), (1, 4, 2)])
def test_sharded_sweep_against_the_reference(shape):  # jaxlint: disable=JL018 -- N=90, H=12 on the reference's 8 virtual devices: two compiles
    k, h, r = shape
    x, _ = make_blobs(n_samples=90, n_features=4, centers=3,
                      cluster_std=0.5, random_state=7)
    x = x.astype(np.float32)
    jax_config = JaxSweepConfig(n_samples=90, n_features=4, k_values=(2, 3),
                                n_iterations=12, store_matrices=True,
                                k_interleave=True)
    ref = jax_run_sweep(JaxKMeans(n_init=3), jax_config, x, 23,
                        mesh=jax_resample_mesh(jax.devices()[:k * h * r],
                                               row_shards=r, k_shards=k))
    got = run_sweep(KMeans(n_init=3),
                    config_from_jax(dataclasses.asdict(jax_config)), x, 23,
                    mesh=_mesh(k, h, r))
    np.testing.assert_array_equal(got["iij"], ref["iij"])
    np.testing.assert_array_equal(got["mij"][1], ref["mij"][1])  # K=3
    band = np.maximum(0.02, 0.25 * ref["pac_area"])
    assert (np.abs(got["pac_area"] - ref["pac_area"]) <= band).all()


# -- resume across meshes ---------------------------------------------------


def _cut_and_resume(make, tmp_path, data, **run_kw):
    """Run engine ``make(0)`` until a fault before block 2, then resume
    the ring with engine ``make(1)``."""
    ring = StreamCheckpointer(str(tmp_path))
    faults.configure("block_start=2")
    try:
        with pytest.raises(InjectedFault):
            make(0).run(data, SEED, H, checkpointer=ring)
    finally:
        faults.clear()
    out = make(1).run(data, SEED, H, checkpointer=ring, **run_kw)
    ring.close()
    return out


@pytest.mark.parametrize("accum_repr", ["dense", "packed"])
def test_stream_frame_resumes_under_another_mesh(tmp_path, data, one_device,
                                                 accum_repr):
    config = _config(stream_h_block=8, accum_repr=accum_repr)
    meshes = [_mesh(1, 2, 2), _mesh(1, 4, 1)]  # both pad blocks to 8

    def make(i):
        return StreamingSweep(KMeans(n_init=2), config, mesh=meshes[i])

    got = _cut_and_resume(make, tmp_path, data)
    assert got["streaming"]["resumed_from_block"] == 2
    _equal(got, one_device, MATS)


def test_estimator_frame_resumes_under_another_mesh(tmp_path, data,
                                                    one_device_estimates):
    config = _estimator_config("packed")
    meshes = [_mesh(1, 2, 2), _mesh(1, 4, 1)]

    def make(i):
        return PairConsensusEngine(KMeans(n_init=2), config, n_pairs=301,
                                   mesh=meshes[i])

    got = _cut_and_resume(make, tmp_path, data, return_state=True)
    want = one_device_estimates["packed"]
    assert got["streaming"]["resumed_from_block"] == 2
    _equal(got, want, CURVES)
    _equal(got["pair_state"], want["pair_state"], ("mij", "iij"))


def test_frame_of_another_padded_block_is_refused(tmp_path, data):  # jaxlint: disable=JL018 -- CPU port only, N=61, H=21
    config = _config(stream_h_block=8, accum_repr="packed")
    ring = StreamCheckpointer(str(tmp_path))
    faults.configure("block_start=1")
    try:
        with pytest.raises(InjectedFault):
            StreamingSweep(KMeans(n_init=2), config, mesh=_mesh(1, 2, 2)).run(
                data, SEED, H, checkpointer=ring)
    finally:
        faults.clear()
    # (1, 1, 3) pads the block of 8 to 9: another resample grid.
    with pytest.raises(ValueError, match="padded blocks of 8"):
        StreamingSweep(KMeans(n_init=2), config, mesh=_mesh(1, 1, 3)).run(
            data, SEED, H, checkpointer=ring)
    ring.close()


# -- refusals and surfaces --------------------------------------------------


def test_k_mesh_refused_by_the_estimator_and_auto_runs_exact(data,  # jaxlint: disable=JL018 -- CPU port only, N=61, H=21
                                                              monkeypatch):
    with pytest.raises(ValueError, match="'h'/'n'"):
        ConsensusClustering(K_range=KS, n_iterations=H, random_state=SEED,
                            mesh=_mesh(2, 1, 1), mode="estimate",
                            store_matrices=False, plot_cdf=False).fit(data)
    monkeypatch.setenv("CCTPU_MEMORY_BUDGET", "1000")
    fit = ConsensusClustering(K_range=KS, n_iterations=H, random_state=SEED,
                              mesh=_mesh(2, 1, 1), mode="auto",
                              store_matrices=False, plot_cdf=False).fit(data)
    assert fit.metrics_.get("mode") != "estimate"


def test_cli_row_shards_equals_the_api_fit(tmp_path, capsys):  # jaxlint: disable=JL018 -- CPU port only, N=60, H=10
    from consensus_clustering_tpu_torch.cli import main

    out = tmp_path / "run.json"
    main(["run", "--dataset", "blobs", "--n-samples", "60", "--n-features",
          "3", "--k", "2:4", "--iterations", "10", "--row-shards", "2",
          "--k-shards", "2", "--k-interleave", "--device", "cpu", "--out",
          str(out)])
    result = json.loads(out.read_text())
    assert result["metrics"]["kernel_launches"] is not None
    from consensus_clustering_tpu_torch.cli import _load_dataset

    x = _load_dataset("blobs", 60, 3, 23)
    fit = ConsensusClustering(K_range=range(2, 5), n_iterations=10,
                              random_state=23, device="cpu",
                              clusterer_options={"n_init": 3},
                              store_matrices=False, plot_cdf=False).fit(x)
    assert result["pac_area"] == {str(k): fit.cdf_at_K_data[k]["pac_area"]
                                  for k in range(2, 5)}
    main(["run", "--dataset", "blobs", "--n-samples", "60", "--n-features",
          "3", "--k", "2:3", "--iterations", "4", "--k-interleave",
          "--device", "cpu"])
    assert "--k-interleave has no effect" in capsys.readouterr().err


def test_scheduler_offers_the_sharded_footprint_on_cuda(tmp_path,
                                                        monkeypatch):
    from consensus_clustering_tpu_torch.serve import (
        ConsensusService,
        SweepExecutor,
    )

    svc = ConsensusService(store_dir=str(tmp_path), port=0,
                           executor=SweepExecutor(device="cpu"),
                           memory_budget_bytes=4096)
    scheduler = svc.scheduler
    from consensus_clustering_tpu_torch.serve.preflight import (
        estimate_estimator_bytes,
    )

    est = estimate_estimator_bytes(100_000, 50, (2, 3), 100, h_block=100)
    assert scheduler._device_count() == 1
    assert scheduler._sharded_disclosure(est) is None
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(scheduler.executor, "device",
                        torch.device("cuda", 0))
    assert scheduler._device_count() == 4
    sharded = scheduler._sharded_disclosure(est)
    assert sharded["devices"] == 4 and "fits_budget" in sharded
