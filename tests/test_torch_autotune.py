"""The port's autotune on the CPU: the calibration store's write side,
the policy, the probe harness and the API's resolution, held to the JAX
package's rules and refusing its records.

The port's twins of ``tests/test_autotune.py``'s fast cases (record round
trip, unknown knob, foreign fingerprint, mislabelled slot, schema version,
broken files listed, precedence, exhausted budget, the structural parity
gate, the host backend a no-op), plus a smoke probe run through the
command line, the cross-package refusal in both directions, and a device
fit disclosing every provenance tier.
"""

import dataclasses
import json
import logging
import os

import numpy as np
import pytest

from consensus_clustering_tpu.autotune.store import (
    CalibrationStore as JaxStore,
    environment as jax_environment,
    make_record as jax_make_record,
)
from consensus_clustering_tpu_torch import ConsensusClustering
from consensus_clustering_tpu_torch.autotune.policy import (
    PROVENANCE_CALIBRATED,
    PROVENANCE_DEFAULT,
    PROVENANCE_USER,
    AutotunePolicy,
)
from consensus_clustering_tpu_torch.autotune.probes import (
    Budget,
    ProbeContext,
    list_probes,
    pac_parity,
    run_probes,
)
from consensus_clustering_tpu_torch.autotune.store import (
    SCHEMA_VERSION,
    CalibrationError,
    CalibrationStore,
    ForeignFingerprintError,
    SchemaVersionError,
    env_fingerprint,
    environment,
    load_record,
    make_record,
    shape_bucket,
)
from consensus_clustering_tpu_torch.config import autotune_stream_block
from consensus_clustering_tpu_torch.ops import _build

BUCKET = shape_bucket(500, 16, 100, (2, 3, 4))


def _passing_parity(tolerance=0.0, delta=0.0):
    return {
        "gate": "bit-identical" if tolerance == 0.0 else "tolerance",
        "tolerance": tolerance,
        "max_pac_delta": delta,
        "k_values_compared": 3,
        "passed": True,
    }


def _record(knob="cluster_batch", value=16, **kw):
    return make_record(knob, BUCKET, value, parity=_passing_parity(), **kw)


def _store_with(tmp_path, knob, value, bucket=BUCKET, **kw):
    store = CalibrationStore(str(tmp_path))
    store.save(make_record(knob, bucket, value, parity=_passing_parity(),
                           env=store.env, **kw))
    return store


# -- store ---------------------------------------------------------------


def test_environment_names_the_torch_stack():
    env = environment()
    assert set(env) == {"device_kind", "backend", "driver_version",
                        "torch_version", "cuda_version", "device_count"}
    assert environment("cpu")["device_kind"] == "cpu"
    assert environment("cpu")["backend"] == "torch-cpu"
    assert env_fingerprint(env) == env_fingerprint(dict(env))
    assert env_fingerprint(dict(env, device_kind="NVIDIA H100")) != (
        env_fingerprint(env))
    assert shape_bucket(500, 16, 100, (4, 2, 3)) == "n500_d16_h100_k2-4"


def test_record_round_trip(tmp_path):
    store = CalibrationStore(str(tmp_path))
    record = _record(rate=120.0, baseline_rate=100.0, probe="test")
    path = store.save(record)
    assert not os.path.exists(path + ".tmp")
    loaded = store.get("cluster_batch", BUCKET)
    assert loaded == record and loaded["speedup"] == 1.2
    assert store.get("cluster_batch", "n1_d1_h1_k2-2") is None
    assert store.get("max_iter", BUCKET) is None


def test_parity_gate_is_structural(tmp_path):
    with pytest.raises(CalibrationError, match="parity"):
        make_record("max_iter", BUCKET, 25, parity={
            "passed": False, "max_pac_delta": 0.5, "tolerance": 0.0})
    with pytest.raises(CalibrationError, match="parity"):
        make_record("max_iter", BUCKET, 25, parity={})
    record = _record()
    record["parity"]["passed"] = False
    with pytest.raises(CalibrationError, match="parity"):
        CalibrationStore(str(tmp_path)).save(record)


def test_unknown_knob_rejected(tmp_path):
    with pytest.raises(CalibrationError, match="unknown knob"):
        make_record("warp_speed", BUCKET, 9, parity=_passing_parity())
    record = _record()
    record["knob"] = "warp_speed"
    with pytest.raises(CalibrationError, match="unknown knob"):
        CalibrationStore(str(tmp_path)).save(record)


def test_foreign_fingerprint_refused(tmp_path):
    foreign_env = dict(environment(), device_kind="NVIDIA A100")
    foreign = CalibrationStore(str(tmp_path), env=foreign_env)
    foreign.save(make_record("stream_h_block", BUCKET, 64,
                             parity=_passing_parity(), env=foreign_env))
    local = CalibrationStore(str(tmp_path))
    assert local.get("stream_h_block", BUCKET) is None
    os.rename(foreign._path("stream_h_block", BUCKET, foreign.env_fp),
              local._path("stream_h_block", BUCKET, local.env_fp))
    with pytest.raises(ForeignFingerprintError, match="different"):
        local.get("stream_h_block", BUCKET)


def test_mislabelled_slot_refused(tmp_path):
    store = _store_with(tmp_path, "stream_h_block", 48)
    os.rename(store._path("stream_h_block", BUCKET, store.env_fp),
              store._path("cluster_batch", BUCKET, store.env_fp))
    with pytest.raises(ForeignFingerprintError, match="mislabelled"):
        store.get("cluster_batch", BUCKET)
    _store_with(tmp_path, "max_iter", 25)
    os.rename(store._path("max_iter", BUCKET, store.env_fp),
              store._path("max_iter", "n9_d9_h9_k2-2", store.env_fp))
    with pytest.raises(ForeignFingerprintError, match="mislabelled"):
        store.get("max_iter", "n9_d9_h9_k2-2")


def test_schema_version_rejected(tmp_path):
    store = CalibrationStore(str(tmp_path))
    record = _record()
    path = store.save(record)
    doctored = dict(record, schema_version=SCHEMA_VERSION + 1)
    with open(path, "w") as f:
        json.dump(doctored, f)
    with pytest.raises(SchemaVersionError, match="schema_version"):
        store.get("cluster_batch", BUCKET)
    with pytest.raises(SchemaVersionError):
        load_record(path)
    with pytest.raises(SchemaVersionError):
        store.save(doctored)


def test_records_listing_surfaces_broken_files(tmp_path):
    store = CalibrationStore(str(tmp_path))
    store.save(_record())
    with open(os.path.join(str(tmp_path), "zz__bad__bucket.json"), "w") as f:
        f.write("{not json")
    listed = store.records()
    assert len(listed) == 2 and any("error" in r for _, r in listed)
    foreign_env = dict(environment(), device_kind="NVIDIA A100")
    CalibrationStore(str(tmp_path), env=foreign_env).save(make_record(
        "max_iter", BUCKET, 25, parity=_passing_parity(), env=foreign_env))
    assert len(store.records()) == 3
    assert len(store.records(all_envs=False)) == 2


# -- policy --------------------------------------------------------------


def test_precedence_user_beats_calibrated_beats_default(tmp_path):
    policy = AutotunePolicy(_store_with(tmp_path, "cluster_batch", 16))
    pinned = policy.resolve("cluster_batch", BUCKET, pinned=4)
    assert (pinned.value, pinned.provenance) == (4, PROVENANCE_USER)
    calibrated = policy.resolve("cluster_batch", BUCKET)
    assert (calibrated.value, calibrated.provenance) == (
        16, PROVENANCE_CALIBRATED)
    assert calibrated.disclosure()["parity"]["passed"] is True
    missing = policy.resolve("max_iter", BUCKET, default=100)
    assert (missing.value, missing.provenance) == (100, PROVENANCE_DEFAULT)
    bare = AutotunePolicy(None).resolve("cluster_batch", BUCKET)
    assert (bare.value, bare.provenance) == (None, PROVENANCE_DEFAULT)


def test_stream_block_tiers_end_at_the_heuristic(tmp_path):
    policy = AutotunePolicy(_store_with(tmp_path, "stream_h_block", 48))
    tiers = [
        policy.resolve_stream_block(BUCKET, job_pin=8, operator_pin=24,
                                    n_iterations=100),
        policy.resolve_stream_block(BUCKET, operator_pin=24,
                                    n_iterations=100),
        policy.resolve_stream_block(BUCKET, n_iterations=100),
        policy.resolve_stream_block("n9_d9_h9_k2-2", n_iterations=400),
    ]
    assert [(r.value, r.provenance) for r in tiers] == [
        (8, PROVENANCE_USER), (24, PROVENANCE_USER),
        (48, PROVENANCE_CALIBRATED),
        (autotune_stream_block(400), PROVENANCE_DEFAULT)]


def test_broken_record_falls_back_to_default(tmp_path, caplog):
    store = _store_with(tmp_path, "cluster_batch", 16)
    path = store._path("cluster_batch", BUCKET, store.env_fp)
    with open(path) as f:
        record = json.load(f)
    record["schema_version"] = SCHEMA_VERSION + 7
    with open(path, "w") as f:
        json.dump(record, f)
    with caplog.at_level(
            logging.WARNING,
            logger="consensus_clustering_tpu_torch.autotune.policy"):
        res = AutotunePolicy(store).resolve("cluster_batch", BUCKET)
    assert res.provenance == PROVENANCE_DEFAULT
    assert "ignoring calibration record" in caplog.text


# -- probe harness -------------------------------------------------------


def test_registry_and_parity_modes():
    assert {p.name for p in list_probes()} == {
        "max_iter", "cluster_batch", "split_init", "stream_h_block",
        "adaptive_tol"}
    identical = pac_parity([0.1234567, 0.2], [0.1234567, 0.2])
    assert identical["passed"] and identical["gate"] == "bit-identical"
    assert pac_parity([0.123456], [0.123459])["passed"]
    assert not pac_parity([0.1235], [0.1234])["passed"]
    within = pac_parity([0.105], [0.1], tolerance=0.01)
    assert within["passed"] and within["gate"] == "tolerance"
    assert not pac_parity([0.12], [0.1], tolerance=0.01)["passed"]
    assert not pac_parity([0.1], [0.1, 0.2])["passed"]


def test_exhausted_budget_skips_every_probe(tmp_path):
    ctx = ProbeContext(store=CalibrationStore(str(tmp_path)),
                       budget=Budget(0.0), shapes="smoke", device="cpu")
    names = [p.name for p in list_probes()]
    summaries, gate_failed = run_probes(names, ctx)
    assert not gate_failed
    assert [s["status"] for s in summaries] == ["budget-skipped"] * len(names)
    assert not [p for p in os.listdir(str(tmp_path)) if p.endswith(".json")]


def test_smoke_probe_through_the_cli_writes_a_gated_record(
        tmp_path, monkeypatch, capsys):
    from consensus_clustering_tpu_torch.cli import main

    monkeypatch.setattr(_build, "BUILD_DIR", _build.BUILD_DIR)
    store_dir = str(tmp_path / "cal")
    with pytest.raises(SystemExit) as exc:
        main(["autotune", "run", "--shapes", "smoke", "--probe",
              "stream_h_block", "--device", "cpu", "--store", store_dir,
              "--budget", "120"])
    assert exc.value.code == 0
    payload = json.loads(capsys.readouterr().out)
    assert payload["gate_failed"] is False and payload["device"] == "cpu"
    assert payload["records_written"] == 1
    [(path, record)] = CalibrationStore(store_dir).records()
    assert record["parity"]["passed"]
    assert record["parity"]["max_pac_delta"] == 0
    assert record["env"] == environment("cpu")
    assert record["bucket"] == "n200_d8_h48_k2-4"
    assert record["value"] in (16, 24)
    ref = jax_make_record(
        record["knob"], record["bucket"], record["value"],
        parity=record["parity"], rate=record["rate"],
        baseline_rate=record["baseline_rate"], probe=record["probe"],
        evidence=record["evidence"], env=jax_environment())
    assert set(record) == set(ref)
    # The speedup is of the unrounded rates here, of the record's rounded
    # ones in the rebuilt reference.
    assert abs(record["speedup"] - ref["speedup"]) <= 0.01
    mine = ("env", "env_fingerprint", "speedup")
    assert {k: v for k, v in record.items() if k not in mine} == {
        k: v for k, v in ref.items() if k not in mine}
    with pytest.raises(SystemExit) as exc:
        main(["autotune", "show", "--store", store_dir, "--this-env-only"])
    shown = json.loads(capsys.readouterr().out)
    assert [r["path"] for r in shown["records"]] == [path]


def test_records_of_each_package_are_foreign_to_the_other(tmp_path):
    jax_dir, port_dir = str(tmp_path / "jax"), str(tmp_path / "port")
    jax_store = JaxStore(jax_dir)
    jax_path = jax_store.save(jax_make_record(
        "stream_h_block", BUCKET, 64, parity=_passing_parity(),
        env=jax_store.env))
    port_store = CalibrationStore(port_dir)
    port_path = port_store.save(make_record(
        "stream_h_block", BUCKET, 32, parity=_passing_parity(),
        env=port_store.env))
    assert jax_store.env_fp != port_store.env_fp
    # Keyed apart by filename: neither resolves the other's record ...
    assert CalibrationStore(jax_dir).get("stream_h_block", BUCKET) is None
    assert JaxStore(port_dir).get("stream_h_block", BUCKET) is None
    # ... and renamed into the other's slot, each is refused.
    os.rename(jax_path, port_store._path("stream_h_block", BUCKET,
                                         port_store.env_fp) + ".x")
    os.rename(port_path, jax_store._path("stream_h_block", BUCKET,
                                         jax_store.env_fp))
    os.rename(port_store._path("stream_h_block", BUCKET,
                               port_store.env_fp) + ".x",
              port_store._path("stream_h_block", BUCKET, port_store.env_fp))
    with pytest.raises(ForeignFingerprintError):
        port_store.get("stream_h_block", BUCKET)
    from consensus_clustering_tpu.autotune.store import (
        ForeignFingerprintError as JaxForeign,
    )

    with pytest.raises(JaxForeign):
        jax_store.get("stream_h_block", BUCKET)


# -- surfaces ------------------------------------------------------------


def test_calibrated_tier_reaches_the_executor(tmp_path):
    from consensus_clustering_tpu_torch.serve import (
        SweepExecutor,
        parse_job_spec,
    )

    spec, x = parse_job_spec({
        "data": [[0.0, 1.0], [1.0, 0.0], [2.0, 2.0], [3.0, 1.0]],
        "config": {"k": [2], "iterations": 400}})
    n, d = x.shape
    store = _store_with(tmp_path, "stream_h_block", 32,
                        bucket=shape_bucket(n, d, 400, (2,)))
    ex = SweepExecutor(device="cpu", calibration_store=store)
    res = ex._resolve_h_block(spec, n, d)
    assert (res.value, res.provenance) == (32, PROVENANCE_CALIBRATED)
    res = ex._resolve_h_block(dataclasses.replace(spec, stream_h_block=8),
                              n, d)
    assert (res.value, res.provenance) == (8, PROVENANCE_USER)
    res = ex._resolve_h_block(dataclasses.replace(spec, n_iterations=800),
                              n, d)
    assert (res.value, res.provenance) == (100, PROVENANCE_DEFAULT)


def _two_blobs():
    rng = np.random.default_rng(0)
    return np.concatenate([rng.normal(0, 0.3, (20, 4)),
                           rng.normal(3, 0.3, (20, 4))]).astype(np.float32)


@pytest.mark.parametrize("autotune", [True, False])
def test_host_backend_is_an_autotune_noop(tmp_path, autotune):  # jaxlint: disable=JL018 -- the port's host backend at n=40, H=5
    import sklearn.cluster

    _store_with(tmp_path, "cluster_batch", 4,
                bucket=shape_bucket(40, 4, 5, (2, 3)))
    cc = ConsensusClustering(
        clusterer=sklearn.cluster.KMeans(n_init=2), K_range=(2, 3),
        n_iterations=5, random_state=7, progress=False, device="cpu",
        store_matrices=False, autotune=autotune,
        calibration_dir=str(tmp_path), plot_cdf=False).fit(_two_blobs())
    assert cc.autotune_ is None and "autotune" not in cc.metrics_


def test_device_fit_discloses_every_tier(tmp_path):  # jaxlint: disable=JL018 -- the port's fits at n=40, H=6 (~1 s); no JAX compile
    bucket = shape_bucket(40, 4, 6, (2, 3))
    store = _store_with(tmp_path, "cluster_batch", 3, bucket=bucket)
    store.save(make_record("max_iter", bucket, 25, parity=_passing_parity(),
                           env=store.env))
    # Streaming measured slower than the monolithic sweep: not adopted.
    store.save(make_record("stream_h_block", bucket, 3,
                           parity=_passing_parity(), rate=50.0,
                           baseline_rate=100.0, env=store.env))
    kwargs = dict(K_range=(2, 3), n_iterations=6, random_state=7,
                  device="cpu", store_matrices=False)
    x = _two_blobs()
    cc = ConsensusClustering(**kwargs, split_init=False, autotune=True,
                             calibration_dir=str(tmp_path),
                             plot_cdf=False).fit(x)
    disclosed = cc.metrics_["autotune"]
    assert cc.autotune_ == disclosed
    assert disclosed["cluster_batch"]["provenance"] == PROVENANCE_CALIBRATED
    assert disclosed["cluster_batch"]["value"] == 3
    assert disclosed["cluster_batch"]["parity"]["passed"] is True
    assert disclosed["split_init"] == {"value": False,
                                       "provenance": PROVENANCE_USER}
    assert disclosed["stream_h_block"] == {"value": None,
                                           "provenance": PROVENANCE_DEFAULT}
    assert disclosed["max_iter"]["provenance"] == PROVENANCE_CALIBRATED
    pinned = ConsensusClustering(
        **kwargs, clusterer_options={"n_init": 3, "max_iter": 25},
        cluster_batch=3, plot_cdf=False).fit(x)
    assert [cc.cdf_at_K_data[k]["pac_area"] for k in (2, 3)] == [
        pinned.cdf_at_K_data[k]["pac_area"] for k in (2, 3)]
    # A record whose streaming beat the monolithic sweep is adopted.
    store.save(make_record("stream_h_block", bucket, 3,
                           parity=_passing_parity(), rate=150.0,
                           baseline_rate=100.0, env=store.env))
    streamed = ConsensusClustering(**kwargs, autotune=True,
                                   calibration_dir=str(tmp_path),
                                   plot_cdf=False).fit(x)
    assert streamed.metrics_["autotune"]["stream_h_block"]["provenance"] == (
        PROVENANCE_CALIBRATED)
    assert streamed.metrics_["streaming"]["h_block"] == 3
    off = ConsensusClustering(**kwargs, plot_cdf=False).fit(x)
    assert off.autotune_ is None and "autotune" not in off.metrics_
