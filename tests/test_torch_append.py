"""The port's incremental append against the reference package's.

- ``PlaneStore``: round trip, newest verifiable generation, torn writes,
  schema skew (the reference's own store tests), int32 bit patterns kept.
- The mixing copy equals the reference's functions on the same inputs.
- The device route of the merged curves and of the staleness report equals
  the numpy ``curves_for_planes`` and the reference's ``staleness_report``
  bit for bit on the same planes; the Iij accounting check.
- ``generation_seed`` equals the reference's (JAX's randint) bit for bit.
- ``check_compat``, the backend included: a reference-backend manifest is
  refused without :func:`..convert.plane_store_from_jax`.
- On a parent carried across by ``plane_store_from_jax``, port and
  reference ``run_append``: Iij equal bit for bit, Mij equal on separated
  blobs, PAC banded; a second append stacks generations.
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch

from consensus_clustering_tpu.append import mixing as jax_mixing
from consensus_clustering_tpu.append import (
    PlaneStore as JaxPlaneStore,
    bootstrap_generation as jax_bootstrap_generation,
    generation_seed as jax_generation_seed,
    run_append as jax_run_append,
)
from consensus_clustering_tpu.append.staleness import (
    staleness_report as jax_staleness_report,
)
from consensus_clustering_tpu.config import SweepConfig as JaxSweepConfig
from consensus_clustering_tpu.models.kmeans import KMeans as JaxKMeans
from consensus_clustering_tpu_torch.append import (
    PlaneStore,
    PlaneStoreError,
    bootstrap_generation,
    check_compat,
    curves_for_planes,
    generation_seed,
    merge_generations,
    run_append,
    staleness_report,
)
from consensus_clustering_tpu_torch.append import mixing
from consensus_clustering_tpu_torch.append.engine import (
    iij_accounting_holds,
)
from consensus_clustering_tpu_torch.config import SweepConfig
from consensus_clustering_tpu_torch.convert import plane_store_from_jax
from consensus_clustering_tpu_torch.data import make_blobs
from consensus_clustering_tpu_torch.models.kmeans import KMeans
from consensus_clustering_tpu_torch.ops.bitpack import (
    pack_cosample_planes,
    pack_label_planes,
)
from consensus_clustering_tpu_torch.utils.checkpoint import data_fingerprint


def _rand_planes(rng, n_ks=2, k_max=3, words=2, n=17):
    return {
        "planes": rng.integers(0, 2**32, size=(n_ks, k_max, words, n),
                               dtype=np.uint32),
        "coplanes": rng.integers(0, 2**32, size=(words, n), dtype=np.uint32),
    }


def _valid_planes(seed, n_ks=2, k_max=4, h=70, n=41, n_sub=33):
    """The packed state of random labels on random subsamples: planes a
    real run could hold (one cluster an element a resample)."""
    rng = np.random.default_rng(seed)
    idx = torch.as_tensor(np.stack([rng.permutation(n)[:n_sub]
                                    for _ in range(h)]))
    planes = np.stack([pack_label_planes(
        torch.as_tensor(rng.integers(0, k_max, size=(h, n_sub))), idx,
        k_max, n).numpy() for _ in range(n_ks)])
    cop = pack_cosample_planes(idx, n).numpy()
    return {"planes": planes.view(np.uint32), "coplanes": cop.view(np.uint32)}


def _manifest(n=17, h=8):
    return {
        "n": n, "n_features": 3, "seed": 23, "h_done": h, "data_sha": "x",
        "config": {"k_values": [2, 3], "subsampling": 0.8, "bins": 20,
                   "pac_interval": [0.1, 0.9], "parity_zeros": True,
                   "dtype": "float32"},
        "backend": "torch-cpu",
        "clusterer": {"name": "kmeans", "options": {}},
        "generations": [{"generation": 0, "h": h, "n": n, "seed": 23}],
    }


# -- the store ------------------------------------------------------------


class TestPlaneStore:
    def test_round_trip(self, tmp_path):
        store = PlaneStore(str(tmp_path / "pl"))
        arrays = _rand_planes(np.random.default_rng(0))
        store.write_generation(0, _manifest(), arrays)
        manifest, loaded = store.load_latest()
        assert manifest["generation"] == 0
        assert manifest["schema"] == "planes-v1"
        assert manifest["backend"] == "torch-cpu"
        np.testing.assert_array_equal(loaded["planes"], arrays["planes"])
        np.testing.assert_array_equal(loaded["coplanes"], arrays["coplanes"])

    def test_int32_bit_patterns_are_viewed(self, tmp_path):
        arrays = _rand_planes(np.random.default_rng(14))
        store = PlaneStore(str(tmp_path / "pl"))
        store.write_generation(0, _manifest(), {
            name: v.view(np.int32) for name, v in arrays.items()})
        _, loaded = store.load_latest()
        assert loaded["planes"].dtype == np.uint32
        np.testing.assert_array_equal(loaded["planes"], arrays["planes"])

    def test_newest_verifiable_generation_wins(self, tmp_path):
        rng = np.random.default_rng(1)
        store = PlaneStore(str(tmp_path / "pl"))
        store.write_generation(0, _manifest(), _rand_planes(rng))
        g1 = _rand_planes(rng)
        store.write_generation(1, _manifest(), g1)
        manifest, loaded = store.load_latest()
        assert manifest["generation"] == 1
        np.testing.assert_array_equal(loaded["planes"], g1["planes"])

    def test_no_store(self, tmp_path):
        with pytest.raises(PlaneStoreError) as e:
            PlaneStore(str(tmp_path / "missing")).load_latest()
        assert e.value.reason == "no_store"

    def test_torn_write_refused_falls_back_to_prior_gen(self, tmp_path):
        rng = np.random.default_rng(2)
        store = PlaneStore(str(tmp_path / "pl"))
        g0 = _rand_planes(rng)
        store.write_generation(0, _manifest(), g0)
        store.write_generation(1, _manifest(), _rand_planes(rng))
        arrays_path = tmp_path / "pl" / "gen-00000001" / "arrays.npz"
        raw = bytearray(arrays_path.read_bytes())
        raw[len(raw) // 2] ^= 0xFF
        arrays_path.write_bytes(bytes(raw))
        manifest, loaded = store.load_latest()
        assert manifest["generation"] == 0
        np.testing.assert_array_equal(loaded["planes"], g0["planes"])

    def test_all_generations_torn_raises(self, tmp_path):
        store = PlaneStore(str(tmp_path / "pl"))
        store.write_generation(0, _manifest(),
                               _rand_planes(np.random.default_rng(3)))
        (tmp_path / "pl" / "gen-00000000" / "arrays.npz").write_bytes(
            b"not an npz")
        with pytest.raises(PlaneStoreError) as e:
            store.load_latest()
        assert e.value.reason in ("arrays_unreadable", "digest_mismatch")

    def test_missing_manifest_is_invisible(self, tmp_path):
        rng = np.random.default_rng(4)
        store = PlaneStore(str(tmp_path / "pl"))
        store.write_generation(0, _manifest(), _rand_planes(rng))
        store.write_generation(1, _manifest(), _rand_planes(rng))
        os.remove(tmp_path / "pl" / "gen-00000001" / "manifest.json")
        manifest, _ = store.load_latest()
        assert manifest["generation"] == 0

    def test_schema_skew_refused(self, tmp_path):
        store = PlaneStore(str(tmp_path / "pl"))
        store.write_generation(0, _manifest(),
                               _rand_planes(np.random.default_rng(5)))
        mpath = tmp_path / "pl" / "gen-00000000" / "manifest.json"
        record = json.loads(mpath.read_text())
        record["schema"] = "planes-v0"
        mpath.write_text(json.dumps(record))
        with pytest.raises(PlaneStoreError) as e:
            store.load_latest()
        assert e.value.reason == "schema_mismatch"


# -- mixing, curves and staleness -----------------------------------------


def test_mixing_copy_equals_reference():
    rng = np.random.default_rng(6)
    a = rng.integers(0, 2**32, size=257, dtype=np.uint32)
    np.testing.assert_array_equal(mixing.popcount_u32(a),
                                  jax_mixing.popcount_u32(a))
    g0, g1 = _rand_planes(rng, n=11), _rand_planes(rng, n=14)
    np.testing.assert_array_equal(mixing.widen_planes(g0["planes"], 14),
                                  jax_mixing.widen_planes(g0["planes"], 14))
    ours = merge_generations([g0, g1], 14)
    ref = jax_mixing.merge_generations([g0, g1], 14)
    for name in ("planes", "coplanes"):
        np.testing.assert_array_equal(ours[name], ref[name])
    with pytest.raises(ValueError):
        merge_generations([g0, _rand_planes(rng, k_max=4)], 17)
    state = _valid_planes(7)
    np.testing.assert_array_equal(mixing.iij_counts(state["coplanes"]),
                                  jax_mixing.iij_counts(state["coplanes"]))
    mij = mixing.mij_counts(state["planes"][0])
    np.testing.assert_array_equal(mij, jax_mixing.mij_counts(
        state["planes"][0]))
    iij = mixing.iij_counts(state["coplanes"])
    cij = mixing.consensus_from_counts(mij, iij)
    np.testing.assert_array_equal(cij, jax_mixing.consensus_from_counts(
        mij, iij))
    counts = mixing.histogram_counts(cij, 20)
    np.testing.assert_array_equal(counts,
                                  jax_mixing.histogram_counts(cij, 20))
    for parity in (True, False):
        got = mixing.curves_from_counts(counts, 41, 2, 18, parity)
        want = jax_mixing.curves_from_counts(counts, 41, 2, 18, parity)
        for a_, b_ in zip(got, want):
            np.testing.assert_array_equal(a_, b_)


@pytest.mark.parametrize("seed,parity", [(8, True), (9, False)])
def test_device_curves_equal_numpy(seed, parity):
    state = _valid_planes(seed, n_ks=3, k_max=5)
    want = jax_mixing.curves_for_planes(
        state["planes"], state["coplanes"], bins=20, pac_lo_idx=2,
        pac_hi_idx=18, parity_zeros=parity)
    got = curves_for_planes(state["planes"], state["coplanes"], bins=20,
                            pac_lo_idx=2, pac_hi_idx=18,
                            parity_zeros=parity, device="cpu")
    for name in ("cdf", "hist"):
        for a_, b_ in zip(got[name], want[name]):
            np.testing.assert_array_equal(a_.view(np.uint32),
                                          b_.view(np.uint32))
    assert got["pac_area"] == want["pac_area"]
    ours = mixing.curves_for_planes(
        state["planes"], state["coplanes"], bins=20, pac_lo_idx=2,
        pac_hi_idx=18, parity_zeros=parity)
    assert ours["pac_area"] == want["pac_area"]


def test_staleness_equals_reference():
    old, new = _valid_planes(10, n=41), _valid_planes(11, n=50, h=40)
    args = dict(n_old=41, k_values=(2, 3), h_old=70, h_new=40,
                subsampling=0.8, bins=20, pac_lo_idx=2, pac_hi_idx=18)
    want = jax_staleness_report(old, new, **args)
    got = staleness_report(old, new, device="cpu", **args)
    assert got == want
    same = staleness_report(old, old, device="cpu", **dict(args, h_new=70))
    assert same["drift"] == 0.0 and not same["refresh_recommended"]


def test_iij_accounting():
    old, new = _valid_planes(12, n=41), _valid_planes(13, n=41, h=40)
    merged = merge_generations([old, new], 41)
    words = {name: torch.from_numpy(a["coplanes"].view(np.int32))
             for name, a in (("old", old), ("new", new), ("merged", merged))}
    assert iij_accounting_holds(words["merged"], words["old"], words["new"],
                                tile_rows=16)
    tampered = words["merged"].clone()
    tampered[0, 7] ^= 1 << 4
    assert not iij_accounting_holds(tampered, words["old"], words["new"],
                                    tile_rows=16)


def test_generation_seed_equals_reference():
    # Seeds below 2^32: above it JAX's PRNGKey depends on jax_enable_x64
    # (the high word is dropped without it), and the port's key follows
    # the x64 form (ROADMAP C3).
    for seed in (0, 23, 2**31 - 1, 2**32 - 1):
        for g in (0, 1, 2, 7, 1000):
            assert generation_seed(seed, g) == jax_generation_seed(seed, g)
    assert generation_seed(23, 0) == 23
    assert len({generation_seed(23, g) for g in range(1, 20)}) == 19


# -- the compat contract --------------------------------------------------


class TestCheckCompat:
    def _x(self, n=17, d=3):
        return np.arange(n * d, dtype=np.float32).reshape(n, d)

    def _ok_manifest(self):
        m = _manifest()
        m["data_sha"] = data_fingerprint(np.ascontiguousarray(self._x()))
        return m

    def test_clean(self):
        assert check_compat(
            self._ok_manifest(), self._x(n=20), backend="torch-cpu",
            k_values=(2, 3), subsampling=0.8, clusterer_name="kmeans",
            clusterer_options={},
        ) is None

    def test_backend_refused(self):
        m = self._ok_manifest()
        assert check_compat(m, self._x(n=20), backend="torch-cuda") == \
            "backend_mismatch:torch-cpu!=torch-cuda"
        del m["backend"]
        assert check_compat(m, self._x(n=20), backend="torch-cpu") == \
            "backend_mismatch:None!=torch-cpu"

    def test_shape_and_config_refused(self):
        m = self._ok_manifest()
        assert check_compat(m, self._x(n=10)).startswith("shrunk_dataset")
        assert check_compat(m, self._x(d=4)) == "feature_count_mismatch"
        assert check_compat(m, self._x(n=20), k_values=(2, 4)) == \
            "config_mismatch:k_values"
        assert check_compat(m, self._x(n=20), bins=40) == \
            "config_mismatch:bins"
        assert check_compat(m, self._x(n=20), clusterer_name="spectral") \
            == "config_mismatch:clusterer"
        assert check_compat(m, self._x(n=20), clusterer_name="kmeans",
                            clusterer_options={"n_init": 3}) == \
            "config_mismatch:clusterer_options"
        x = self._x(n=20)
        x[0, 0] += 1e-3
        assert check_compat(m, x) == "data_prefix_mismatch"


# -- the engine against the reference ---------------------------------------


@pytest.fixture(scope="module")
def blobs():
    x, _ = make_blobs(n_samples=50, n_features=3, centers=3,
                      cluster_std=0.4, random_state=2)
    return x.astype(np.float32)


@pytest.fixture(scope="module")
def reference_parent(blobs, tmp_path_factory):
    """A reference store's generation 0 (N=40, H=16, K=2..3)."""
    root = tmp_path_factory.mktemp("ref_parent")
    config = JaxSweepConfig(n_samples=40, n_features=3, k_values=(2, 3),
                            n_iterations=16, store_matrices=False,
                            accum_repr="packed", stream_h_block=4)
    jax_bootstrap_generation(
        blobs[:40], config=config, clusterer=JaxKMeans(max_iter=5), seed=23,
        store=JaxPlaneStore(str(root / "store")),
        clusterer_meta={"name": "kmeans", "options": {}})
    return str(root / "store")


def test_append_against_reference(blobs, reference_parent, tmp_path):
    ref_dir = str(tmp_path / "ref")
    shutil.copytree(reference_parent, ref_dir)
    with pytest.raises(PlaneStoreError, match="backend_mismatch"):
        run_append(PlaneStore(ref_dir), blobs, h_new=8,
                   clusterer=KMeans(max_iter=5), device="cpu")
    manifest = plane_store_from_jax(ref_dir, str(tmp_path / "port"),
                                    device="cpu")
    assert manifest["backend"] == "torch-cpu"
    assert manifest["generation"] == 0
    with pytest.raises(ValueError, match="not by the reference"):
        plane_store_from_jax(str(tmp_path / "port"), str(tmp_path / "again"))
    common = dict(h_new=8, k_values=(2, 3), subsampling=0.8,
                  clusterer_name="kmeans", clusterer_options={})
    want = jax_run_append(JaxPlaneStore(ref_dir), blobs,
                          clusterer=JaxKMeans(max_iter=5), **common)
    store = PlaneStore(str(tmp_path / "port"))
    got = run_append(store, blobs, clusterer=KMeans(max_iter=5),
                     device="cpu", **common)
    ap = got["append"]
    assert ap["generation"] == 1 and ap["h_total"] == 24
    assert ap["iij_bit_identical"] and ap["store_written"]
    assert not ap["staleness"]["refresh_recommended"]
    assert set(want["append"]) == set(ap)
    _, ref_arrays = JaxPlaneStore(ref_dir).load_latest()
    _, arrays = store.load_latest()
    np.testing.assert_array_equal(arrays["coplanes"], ref_arrays["coplanes"])
    for ki in range(2):
        np.testing.assert_array_equal(
            mixing.mij_counts(arrays["planes"][ki]),
            mixing.mij_counts(ref_arrays["planes"][ki]))
    ref_pac = np.asarray(want["pac_area"])
    assert (np.abs(np.asarray(got["pac_area"]) - ref_pac)
            <= np.maximum(0.02, 0.25 * ref_pac)).all()
    # The device route's curves are the numpy oracle's on the merged state.
    oracle = mixing.curves_for_planes(arrays["planes"], arrays["coplanes"],
                                      bins=20, pac_lo_idx=2, pac_hi_idx=18)
    assert got["pac_area"] == oracle["pac_area"]


def test_bootstrap_and_stacked_appends(blobs, tmp_path):
    config = SweepConfig(n_samples=40, n_features=3, k_values=(2, 3),
                         n_iterations=16, store_matrices=False,
                         accum_repr="packed", stream_h_block=4)
    store = PlaneStore(str(tmp_path / "pl"))
    parent = bootstrap_generation(blobs[:40], config=config,
                                  clusterer=KMeans(max_iter=5), seed=23,
                                  store=store, device="cpu")
    assert parent["store_written"]
    assert parent["final_state"]["planes"].shape[:2] == (2, 3)
    manifest, _ = store.load_latest()
    assert manifest["backend"] == "torch-cpu"
    first = run_append(store, blobs[:45], h_new=8,
                       clusterer=KMeans(max_iter=5), device="cpu")
    second = run_append(store, blobs, h_new=8, clusterer=KMeans(max_iter=5),
                        device="cpu")
    assert first["append"]["generation"] == 1
    assert second["append"]["generation"] == 2
    assert second["append"]["h_total"] == 32
    assert second["append"]["n_old"] == 45
    manifest, arrays = store.load_latest()
    assert [g["generation"] for g in manifest["generations"]] == [0, 1, 2]
    assert arrays["coplanes"].shape == (4 + 2 + 2, 50)
    with pytest.raises(PlaneStoreError, match="data_prefix"):
        run_append(store, blobs[::-1].copy(), h_new=8,
                   clusterer=KMeans(max_iter=5), device="cpu")
