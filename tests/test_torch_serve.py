"""The port's serving stack on the CPU, held against the JAX package.

A real port ``ConsensusService`` on an ephemeral localhost port, driven
over HTTP with a tiny job (n=60, d=4, K 2..3, H 10): round trip, dedup
from the job store, ``/healthz``, ``/metrics`` and ``/metrics.prom``,
400/404/413.  The port executor's PAC equals the port library's fit bit
for bit; against the reference ``SweepExecutor`` the same job has equal
``K`` and ``h_effective`` and PAC within the parity band
max(0.02, 0.25·ref).  The copied modules equal their reference's text
once the package is renamed.
"""

import json
import os
import re
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from consensus_clustering_tpu_torch import ConsensusClustering
from consensus_clustering_tpu_torch.serve import (
    ConsensusService,
    JobSpec,
    JobStore,
    SweepExecutor,
    parse_job_spec,
)
from consensus_clustering_tpu_torch.serve.scheduler import (
    _EXECUTOR_COUNTER_ATTRS,
    _EXECUTOR_OBJECT_ATTRS,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: The modules copied from the reference package without an edit: each
#: equals its source once the package name is renamed, the reference's
#: "PR n's" history references are dropped and the one-line header that
#: names the source is removed.
VERBATIM = (
    "obs/__init__.py", "obs/histograms.py", "obs/tracing.py",
    "obs/drift.py", "obs/slo.py", "obs/prom.py", "obs/memory.py",
    "serve/events.py", "serve/watchdog.py", "serve/leases.py",
    "serve/sched/__init__.py", "serve/sched/fairshare.py",
    "serve/sched/fusion.py", "serve/sched/progressive.py",
    "serve/sched/stream.py", "serve/fleet/__init__.py",
    "serve/fleet/heartbeat.py", "serve/fleet/signal.py",
    "serve/fleet/steal.py", "serve/jobstore.py", "serve/service.py",
    "obs/query.py",
)


def _req(base, path, body=None):
    """(status, parsed json) for one HTTP round trip."""
    req = urllib.request.Request(
        base + path,
        data=None if body is None else json.dumps(body).encode(),
        headers={"Content-Type": "application/json"},
    )
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _poll(base, job_id, budget=120.0):
    deadline = time.time() + budget
    while time.time() < deadline:
        code, rec = _req(base, f"/jobs/{job_id}")
        assert code == 200
        if rec["status"] in ("done", "failed", "timeout"):
            return rec
        time.sleep(0.05)
    raise AssertionError(f"job {job_id} still {rec['status']}")


def _data(seed, n=60, d=4):
    rng = np.random.default_rng(seed)
    half = n // 2
    return np.concatenate([rng.normal(0.0, 0.3, (half, d)),
                           rng.normal(3.0, 0.3, (n - half, d))])


def _body(seed=23, data_seed=1, **config):
    return {"data": _data(data_seed).tolist(),
            "config": {"k": [2, 3], "iterations": 10, "seed": seed,
                       **config}}


@pytest.fixture(scope="module")
def service(tmp_path_factory):
    svc = ConsensusService(
        store_dir=str(tmp_path_factory.mktemp("torch_serve_store")),
        port=0,
        executor=SweepExecutor(device="cpu"),
        events_path=str(tmp_path_factory.mktemp("torch_serve_events")
                        / "ev.jsonl"),
    ).start()
    yield svc
    svc.stop()


@pytest.fixture(scope="module")
def base(service):
    return f"http://127.0.0.1:{service.port}"


def test_submit_poll_result_roundtrip(base, service):
    code, rec = _req(base, "/jobs", _body())
    assert code == 202
    assert rec["status"] == "queued" and rec["from_cache"] is False
    done = _poll(base, rec["job_id"])
    assert done["status"] == "done", done.get("error")
    result = done["result"]
    assert result["K"] == [2, 3] and result["best_k"] in (2, 3)
    assert set(result["pac_area"]) == {"2", "3"}
    assert result["backend"] == "torch-cpu" == service.executor.backend()
    assert result["autotune"]["stream_h_block"] == {
        "value": 16, "provenance": "default"}
    mem = result["memory"]
    assert mem["estimated_bytes"] > 0
    # The CPU has no allocator to read: nothing measured, nothing made up.
    assert mem["measurement_source"] is None
    assert mem["measured_bytes"] is None
    assert mem["preflight_accuracy"] is None


def test_duplicate_submission_served_from_jobstore(base, service):
    body = _body(seed=99)
    code1, rec1 = _req(base, "/jobs", body)
    assert code1 == 202
    first = _poll(base, rec1["job_id"])
    runs_before = service.executor.run_count
    code2, rec2 = _req(base, "/jobs", body)
    assert code2 == 200
    assert rec2["status"] == "done" and rec2["from_cache"] is True
    assert rec2["fingerprint"] == rec1["fingerprint"]
    assert service.executor.run_count == runs_before
    assert (rec2["result"]["result_fingerprint"]
            == first["result"]["result_fingerprint"])


def test_healthz_and_metrics_schemas(base):
    from consensus_clustering_tpu_torch.obs.prom import validate_exposition

    code, health = _req(base, "/healthz")
    assert code == 200
    assert health["status"] == "ok" and health["backend"] == "torch-cpu"
    assert isinstance(health["queue_depth"], int)
    code, m = _req(base, "/metrics")
    assert code == 200
    for key in list(_EXECUTOR_COUNTER_ATTRS) + [
            "queue_depth", "jobs_completed", "latency_histograms",
            "memory_accounting", "perf_drift", "fused_executions_total",
            "autotune_provenance_total", "fleet", "slo"]:
        assert key in m, key
    assert m["backend"] == "torch-cpu"
    with urllib.request.urlopen(base + "/metrics.prom", timeout=30) as r:
        text = r.read().decode()
    assert validate_exposition(text) == []
    assert 'cctpu_backend_info{backend="torch-cpu"} 1' in text
    ex = SweepExecutor(device="cpu")
    for attr in list(_EXECUTOR_COUNTER_ATTRS.values()) + list(
            _EXECUTOR_OBJECT_ATTRS) + ["autotune_provenance", "run_count"]:
        assert hasattr(ex, attr), attr


@pytest.mark.parametrize("body,why", [
    ({"config": {"k": [2, 3]}}, "missing data"),
    ({"data": [[1, 2], [3, 4]], "config": {"k": [9]}}, "k >= n_samples"),
    ({"data": [[1, float("nan")], [3, 4]]}, "NaN"),
    ({"data": [[1, 2], [3, 4], [5, 6]], "config": {"iteration": 5}},
     "unknown config key"),
    ({"data": [[1, 2], [3, 4], [5, 6]], "config": {"mode": "refine"}},
     "internal mode"),
])
def test_bad_requests_rejected(base, body, why):
    code, rec = _req(base, "/jobs", body)
    assert code == 400, why
    assert "error" in rec


def test_unknown_routes_and_jobs_404(base):
    assert _req(base, "/nope")[0] == 404
    assert _req(base, "/jobs/deadbeef")[0] == 404


def test_over_budget_job_refused_with_413(tmp_path):
    svc = ConsensusService(store_dir=str(tmp_path), port=0,
                           executor=SweepExecutor(device="cpu"),
                           memory_budget_bytes=4096).start()
    try:
        code, rec = _req(f"http://127.0.0.1:{svc.port}", "/jobs", _body())
        assert code == 413
        assert rec["budget_bytes"] == 4096
        assert rec["estimated_bytes"] > 4096 and "hint" in rec
        assert svc.executor.run_count == 0
    finally:
        svc.stop()


def test_service_without_executor_needs_a_gpu(tmp_path, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ConsensusService(store_dir=str(tmp_path), port=0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SweepExecutor()


def test_profile_dir_writes_a_torch_profiler_trace(tmp_path):  # jaxlint: disable=JL018 -- the port's executor on the CPU at n=60, H=10 (~1 s); no JAX compile
    spec, x = parse_job_spec(_body(seed=5))
    result = SweepExecutor(device="cpu").run(
        spec, x, profile_dir=str(tmp_path / "prof"))
    assert result["K"] == [2, 3]
    traces = os.listdir(tmp_path / "prof")
    assert len(traces) == 1 and traces[0].endswith(".json")


def test_executor_equals_the_port_library_fit():  # jaxlint: disable=JL018 -- the port's own library fit at n=60, H=10 is the oracle
    spec, x = parse_job_spec(_body(clusterer_options={"n_init": 3}))
    ex = SweepExecutor(device="cpu")
    result = ex.run(spec, x)
    h_block = result["autotune"]["stream_h_block"]["value"]
    cc = ConsensusClustering(K_range=(2, 3), n_iterations=10,
                             random_state=23, device="cpu",
                             stream_h_block=h_block, store_matrices=False,
                             clusterer_options={"n_init": 3},
                             plot_cdf=False).fit(x)
    assert result["pac_area"] == {
        str(k): float(cc.cdf_at_K_data[k]["pac_area"]) for k in (2, 3)}
    assert result["best_k"] == cc.best_k_


def test_executor_against_the_reference_executor():  # jaxlint: disable=JL018 -- the parity gate at n=60, H=10, K 2..3: one small reference compile (~5 s)
    from consensus_clustering_tpu.serve import SweepExecutor as RefExecutor
    from consensus_clustering_tpu.serve import parse_job_spec as ref_parse

    body = _body(clusterer_options={"n_init": 3})
    spec, x = parse_job_spec(body)
    ref_spec, ref_x = ref_parse(body)
    port = SweepExecutor(device="cpu").run(spec, x)
    ref = RefExecutor(use_compilation_cache=False).run(ref_spec, ref_x)
    assert port["K"] == ref["K"]
    assert port["h_effective"] == ref["h_effective"]
    for k in ("2", "3"):
        band = max(0.02, 0.25 * ref["pac_area"][k])
        assert abs(port["pac_area"][k] - ref["pac_area"][k]) <= band, k


def test_job_fingerprint_differs_from_the_reference(tmp_path):
    from consensus_clustering_tpu.serve.jobstore import JobStore as RefStore
    from consensus_clustering_tpu.utils.checkpoint import (
        job_fingerprint as ref_job_fingerprint,
    )
    from consensus_clustering_tpu_torch.utils.checkpoint import (
        job_fingerprint,
    )

    spec, x = parse_job_spec(_body())
    payload = spec.fingerprint_payload()
    assert job_fingerprint(payload, x) != ref_job_fingerprint(payload, x)
    assert (JobStore(str(tmp_path / "a")).fingerprint(payload, x)
            != RefStore(str(tmp_path / "b")).fingerprint(payload, x))
    assert job_fingerprint(payload, x) == job_fingerprint(payload, x.copy())
    again = JobSpec.from_payload(payload)
    assert again.fingerprint_payload() == payload


@pytest.mark.parametrize("rel", VERBATIM)
def test_copied_module_equals_its_reference(rel):
    with open(os.path.join(REPO, "consensus_clustering_tpu", rel)) as f:
        ref = f.read()
    with open(os.path.join(REPO, "consensus_clustering_tpu_torch", rel)) as f:
        header, port = f.read().split("\n", 1)
    assert header == f"# Copied from consensus_clustering_tpu/{rel}."
    ref = re.sub(r"\bconsensus_clustering_tpu\b",
                 "consensus_clustering_tpu_torch", ref)
    assert port == re.sub(r"PR \d+'s ", "", ref)
