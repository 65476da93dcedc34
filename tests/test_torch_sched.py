"""The port's scheduler, fusion batch axis and job modes on the CPU.

- ``SweepExecutor.run_fused`` (the port's ``StreamingSweep.run_fused``,
  one shared block loop) equals solo runs on ``result_fingerprint``,
  ``pac_area`` and ``best_k`` at k = 2, 3 and with ``pad_to``; a solo
  run resumes from fused-written frames.
- A real port ``Scheduler`` fuses two same-bucket jobs at
  ``fusion_max=2``, answers a progressive job with its estimate and then
  its exact refinement, and an append over HTTP equals
  ``append.engine.run_append`` run directly on a copy of the parent's
  plane store.
- The scheduler's failure handling with a stub executor (retry with
  backoff, timeout, queue full, eviction, restart reconciliation).
"""

import json
import os
import shutil
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from consensus_clustering_tpu_torch.serve import (
    ConsensusService,
    JobSpec,
    JobStore,
    QueueFull,
    Scheduler,
    SweepExecutor,
    parse_job_spec,
)


@pytest.fixture(scope="module")
def executor():
    return SweepExecutor(device="cpu")


def _spec(seed, accum_repr="dense", **kwargs):
    return JobSpec(k_values=(2, 3), n_iterations=16, seed=seed,
                   stream_h_block=4, accum_repr=accum_repr, **kwargs)


def _xs(k, n=40):
    rng = np.random.default_rng(7)
    return [rng.normal(size=(n, 3)).astype(np.float32) for _ in range(k)]


def _wait(s, job_id, statuses=("done",), budget=60.0):
    deadline = time.time() + budget
    rec = None
    while time.time() < deadline:
        rec = s.get(job_id)
        if rec and rec["status"] in statuses:
            return rec
        time.sleep(0.02)
    raise AssertionError(f"job {job_id} still {rec and rec.get('status')}")


@pytest.mark.parametrize("k,pad_to,accum_repr", [
    (2, None, "dense"), (3, None, "dense"), (2, 4, "dense"),
    (2, None, "packed"),
])
def test_fused_bit_identical_to_solo(executor, k, pad_to, accum_repr):
    xs = _xs(k)
    specs = [_spec(100 + i, accum_repr) for i in range(k)]
    solo = [executor.run(s, x) for s, x in zip(specs, xs)]
    fused = executor.run_fused(specs, xs, pad_to=pad_to)
    assert len(fused) == k
    for f, s in zip(fused, solo):
        assert f["result_fingerprint"] == s["result_fingerprint"]
        assert f["pac_area"] == s["pac_area"]
        assert f["best_k"] == s["best_k"]
        assert f["streaming"]["pac_trajectory"] == \
            s["streaming"]["pac_trajectory"]
        assert f["fused"] == {"batch": k} and "fused" not in s


def test_run_fused_refuses_what_it_cannot_fuse(executor):
    xs = _xs(2)
    with pytest.raises(ValueError, match=">= 2 jobs"):
        executor.run_fused([_spec(1)], xs[:1])
    with pytest.raises(ValueError, match="n_iterations"):
        executor.run_fused([_spec(1), JobSpec(
            k_values=(2, 3), n_iterations=12, seed=2, stream_h_block=4)],
            xs)
    with pytest.raises(ValueError, match="non-adaptive"):
        executor.run_fused([_spec(1), _spec(2, adaptive_tol=0.1)], xs)


def test_solo_resumes_from_fused_checkpoints(executor, tmp_path):
    xs = _xs(2)
    specs = [_spec(200 + i) for i in range(2)]
    oracle = [executor.run(s, x) for s, x in zip(specs, xs)]
    dirs = [str(tmp_path / f"ring{i}") for i in range(2)]
    fused = executor.run_fused(specs, xs, checkpoint_dirs=dirs)
    assert [f["streaming"]["checkpoint_writes"] for f in fused] == [4, 4]
    gens = sorted(f for f in os.listdir(dirs[0]) if f.startswith("gen-"))
    assert len(gens) >= 2
    os.remove(os.path.join(dirs[0], gens[-1]))
    resumed = executor.run(specs[0], xs[0], checkpoint_dir=dirs[0])
    assert resumed["resumed_from_block"] > 0
    assert resumed["result_fingerprint"] == oracle[0]["result_fingerprint"]


def test_scheduler_fuses_two_same_bucket_jobs(executor, tmp_path):
    xs = _xs(2)
    specs = [_spec(300 + i, tenant=f"t{i}") for i in range(2)]
    oracle = [executor.run(s, x)["result_fingerprint"]
              for s, x in zip(specs, xs)]
    s = Scheduler(executor, JobStore(str(tmp_path / "store")), max_queue=8,
                  fusion_max=2, leases=False)
    # Submitted before the worker starts: the batch is deterministic.
    recs = [s.submit(spec, x) for spec, x in zip(specs, xs)]
    s.start()
    try:
        for rec, fp in zip(recs, oracle):
            done = _wait(s, rec["job_id"])
            assert done["result"]["result_fingerprint"] == fp
            assert done["result"]["fused"] == {"batch": 2}
        # The worker counts a job just after flipping it to done: join it
        # so that the last job's count has landed before the read.
        s.stop()
        m = s.metrics()
        assert m["fused_executions_total"] == 1
        assert m["fused_jobs_total"] == 2
    finally:
        s.stop()


def test_progressive_job_estimate_then_refinement(executor, tmp_path):
    x = _xs(1, n=60)[0]
    spec = JobSpec(k_values=(2, 3), n_iterations=8, seed=5,
                   stream_h_block=4, mode="progressive", n_pairs=256)
    s = Scheduler(executor, JobStore(str(tmp_path / "store")), leases=False)
    s.start()
    try:
        rec = s.submit(spec, x)
        deadline = time.time() + 60.0
        parent = cont_id = None
        while time.time() < deadline:
            parent = s.get(rec["job_id"])
            cont_id = (parent or {}).get("continuation_job_id")
            if cont_id and s.get(cont_id)["status"] == "done":
                break
            time.sleep(0.05)
        assert parent["status"] == "done"
        assert parent["result"]["mode"] == "estimate"
        assert parent["result"]["estimator"]["n_pairs"] == 256
        assert cont_id, "no continuation enqueued"
        cont = s.get(cont_id)
        assert cont["status"] == "done"
        assert cont["continuation_of"] == rec["job_id"]
        refined = cont["result"]
        assert refined["refined"] is True and refined["mode"] == "exact"
        assert refined["K"] == [parent["result"]["best_k"]]
        # The worker counts a job just after flipping it to done: join it
        # so that the continuation's count has landed before the read.
        s.stop()
        m = s.metrics()
        assert m["continuations_completed_total"] == 1
        assert m["estimator_runs_total"] == 1
    finally:
        s.stop()


def _post(base, body):
    req = urllib.request.Request(
        base + "/jobs", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _poll(base, job_id, budget=60.0):
    deadline = time.time() + budget
    while time.time() < deadline:
        with urllib.request.urlopen(f"{base}/jobs/{job_id}",
                                    timeout=30) as r:
            rec = json.loads(r.read())
        if rec["status"] in ("done", "failed", "timeout"):
            return rec
        time.sleep(0.05)
    raise AssertionError(f"job {job_id} still {rec['status']}")


def test_append_over_http_equals_direct_run_append(executor, tmp_path):
    from consensus_clustering_tpu_torch.append import PlaneStore, run_append
    from consensus_clustering_tpu_torch.models.kmeans import KMeans

    rng = np.random.default_rng(3)
    x_old = np.concatenate([rng.normal(0, .3, (30, 3)),
                            rng.normal(3, .3, (30, 3))]).astype(np.float32)
    x_new = np.concatenate([x_old, rng.normal(0, .3, (8, 3)).astype(
        np.float32)])
    config = {"k": [2, 3], "seed": 11, "accum_repr": "packed",
              "stream_h_block": 4}
    svc = ConsensusService(store_dir=str(tmp_path / "store"), port=0,
                           executor=executor).start()
    base = f"http://127.0.0.1:{svc.port}"
    try:
        code, rec = _post(base, {"data": x_old.tolist(),
                                 "config": {**config, "iterations": 8}})
        assert code == 202
        parent = _poll(base, rec["job_id"])
        assert parent["result"]["plane_store"]["generation"] == 0
        copy = str(tmp_path / "planes_copy")
        shutil.copytree(svc.store.plane_dir(parent["fingerprint"]), copy)
        code, rec = _post(base, {"data": x_new.tolist(), "config": {
            **config, "iterations": 4, "mode": "append",
            "append_parent": parent["fingerprint"]}})
        assert code == 202
        appended = _poll(base, rec["job_id"])
        assert appended["status"] == "done", appended.get("error")
    finally:
        svc.stop()
    result = appended["result"]
    assert result["mode"] == "append"
    assert result["append"]["fallback"] is False
    assert result["append"]["generation"] == 1
    assert result["append"]["iij_bit_identical"] is True
    assert "refresh_recommended" in result["append"]["staleness"]
    direct = run_append(PlaneStore(copy), x_new, h_new=4, clusterer=KMeans(),
                        stream_h_block=4, k_values=(2, 3), device="cpu",
                        clusterer_name="kmeans", clusterer_options={})
    assert result["pac_area"] == {
        str(k): float(p) for k, p in zip((2, 3), direct["pac_area"])}
    assert result["append"]["h_total"] == direct["append"]["h_total"] == 12


class _StubExecutor:
    """Duck-typed executor: scripted results, no engine."""

    def __init__(self, script=None, block=None, backend="torch-cpu"):
        self.run_count = 0
        self._script = list(script or [])
        self._block = block
        self._backend = backend

    def backend(self):
        return self._backend

    def cancel_events(self):
        pass

    def run(self, spec, x, progress_cb=None):
        self.run_count += 1
        if self._block is not None:
            self._block.wait()
        step = self._script.pop(0) if self._script else {"ok": True}
        if isinstance(step, Exception):
            raise step
        return {"result": step, "shape": [int(v) for v in x.shape]}


def _stub_spec(seed=23):
    return parse_job_spec(
        {"data": [[0.0, 1.0], [1.0, 0.0], [2.0, 2.0], [3.0, 3.0]],
         "config": {"k": [2], "iterations": 5, "seed": seed}})


def _case_retry(tmp_path):
    sleeps = []
    ex = _StubExecutor(script=[RuntimeError("transient 1"),
                               RuntimeError("transient 2"), 42])
    s = Scheduler(ex, JobStore(str(tmp_path)), max_retries=2,
                  backoff_base=0.5, sleep=sleeps.append)
    s.start()
    try:
        cur = _wait(s, s.submit(*_stub_spec())["job_id"])
        assert cur["attempt"] == 2 and cur["result"]["result"] == 42
        assert sleeps == [0.5, 1.0]
        assert s.metrics()["jobs_retried"] == 2
    finally:
        s.stop()


def _case_timeout(tmp_path):
    gate = threading.Event()
    s = Scheduler(_StubExecutor(block=gate), JobStore(str(tmp_path)),
                  job_timeout=0.2)
    s.start()
    try:
        _wait(s, s.submit(*_stub_spec())["job_id"], ("timeout",))
        assert s.metrics()["jobs_timed_out"] == 1
    finally:
        gate.set()
        s.stop()


def _case_queue_full(tmp_path):
    gate = threading.Event()
    s = Scheduler(_StubExecutor(block=gate), JobStore(str(tmp_path)),
                  max_queue=1)
    s.start()
    try:
        s.submit(*_stub_spec(seed=0))
        deadline = time.time() + 10
        while s.queue_depth() > 0 and time.time() < deadline:
            time.sleep(0.02)
        s.submit(*_stub_spec(seed=1))
        with pytest.raises(QueueFull):
            s.submit(*_stub_spec(seed=2))
    finally:
        gate.set()
        s.stop()


def _case_eviction(tmp_path):
    s = Scheduler(_StubExecutor(script=[42]), JobStore(str(tmp_path)))
    s.start()
    try:
        rec = s.submit(*_stub_spec())
        _wait(s, rec["job_id"])
        deadline = time.time() + 10
        # The record is saved to disk before it leaves memory: wait for
        # the eviction, not for the status.
        while rec["job_id"] in s._jobs and time.time() < deadline:
            time.sleep(0.02)
        assert rec["job_id"] not in s._jobs
        again = s.submit(*_stub_spec())
        assert again["status"] == "done" and again["from_cache"]
        assert s.get(again["job_id"])["result"]["result"] == 42
    finally:
        s.stop()


def _case_restart(tmp_path):
    store = JobStore(str(tmp_path))
    store.save_job({"job_id": "deadjob1", "status": "running"})
    store.save_job({"job_id": "okjob", "status": "done", "result": {}})
    s = Scheduler(_StubExecutor(), store)
    s.start()
    try:
        assert s.get("deadjob1")["status"] == "failed"
        assert "restart" in s.get("deadjob1")["error"]
        assert s.get("okjob")["status"] == "done"
    finally:
        s.stop()


@pytest.mark.parametrize("case", [_case_retry, _case_timeout,
                                  _case_queue_full, _case_eviction,
                                  _case_restart],
                         ids=lambda f: f.__name__[len("_case_"):])
def test_scheduler_failure_handling(case, tmp_path):
    case(tmp_path)


def test_shared_store_keeps_card_and_cpu_results_apart(executor, tmp_path):
    """The job fingerprint carries the executor's backend tag: a result
    computed on the CPU answers a CPU worker's resubmission from a shared
    store, and never a card worker's."""
    first = Scheduler(_StubExecutor(script=[42]), JobStore(str(tmp_path)),
                      leases=False)
    first.start()
    try:
        done = _wait(first, first.submit(*_stub_spec())["job_id"])
        deadline = time.time() + 10
        # The result file is the side effect to wait for, not the status.
        while (first.store.get_result(done["fingerprint"]) is None
               and time.time() < deadline):
            time.sleep(0.02)
    finally:
        first.stop()
    on_cpu = Scheduler(executor, JobStore(str(tmp_path)),
                       leases=False).submit(*_stub_spec())
    on_card = Scheduler(_StubExecutor(backend="torch-cuda"),
                        JobStore(str(tmp_path)),
                        leases=False).submit(*_stub_spec())
    assert on_cpu["fingerprint"] == done["fingerprint"]
    assert on_cpu["status"] == "done" and on_cpu["from_cache"]
    assert on_card["fingerprint"] != done["fingerprint"]
    assert on_card["status"] == "queued"
