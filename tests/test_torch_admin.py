"""The port's ``serve-admin`` and forensic queries on the CPU, held
against the JAX package's tools on the same files.

One job store and one events file are written by the port's scheduler
over a stub executor (a finished job, a failed one) plus a quarantined
orphan.  The port's ``list``, ``show``, ``trace`` and ``report`` and its
``obs.query.summarize``/``render_report`` give the JAX package's output on
them, apart from the bundle's tool name and ``show``'s footprints, which
are the port's own preflight models.  ``release`` round-trips through the
port's ``JobStore``, and ``serve-admin`` in a subprocess imports no
engine module and leaves CUDA uninitialised.
"""

import argparse
import json
import os
import subprocess
import sys
import tarfile
import time

import pytest

from consensus_clustering_tpu.obs import query as jax_query
from consensus_clustering_tpu.serve import admin as jax_admin
from consensus_clustering_tpu_torch.obs import query
from consensus_clustering_tpu_torch.obs.drift import DriftWatchdog
from consensus_clustering_tpu_torch.obs.histograms import LatencyHistogram
from consensus_clustering_tpu_torch.obs.memory import MemoryAccountant
from consensus_clustering_tpu_torch.serve import (
    EventLog,
    JobStore,
    Scheduler,
    parse_job_spec,
)
from consensus_clustering_tpu_torch.serve import admin
from consensus_clustering_tpu_torch.serve import preflight

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class _StubExecutor:
    """Streaming- and obs-shaped stub: scripted results, no engine."""

    default_h_block = 4

    def __init__(self, script=()):
        self.run_count = 0
        self.executable_cache_hits = 0
        self.hist_block_seconds = LatencyHistogram()
        self.hist_checkpoint_write_seconds = LatencyHistogram()
        self.drift = DriftWatchdog(min_observations=1)
        self.memory_accounting = MemoryAccountant(band=(0.5, 2.0))
        self._script = list(script)

    def backend(self):
        return "torch-cpu"

    def cancel_events(self):
        pass

    def run(self, spec, x, progress_cb=None, **kwargs):
        self.run_count += 1
        step = self._script.pop(0) if self._script else {"ok": True}
        if isinstance(step, Exception):
            raise step
        return {"result": step}


def _spec(seed):
    return parse_job_spec({
        "data": [[0.0, 1.0], [1.0, 0.0], [2.0, 2.0], [3.0, 3.0]] * 10,
        "config": {"k": [2, 3], "iterations": 12, "seed": seed,
                   "accum_repr": "packed", "stream_h_block": 4}})


def _wait(sched, job_id):
    deadline = time.time() + 30
    while time.time() < deadline:
        cur = sched.get(job_id)
        if cur["status"] in ("done", "failed", "timeout"):
            return cur
        time.sleep(0.02)
    raise AssertionError(f"job {job_id} never finished")


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """(store_dir, events_path, done job id, failed job id)."""
    root = tmp_path_factory.mktemp("torch_admin")
    store_dir, events_path = str(root / "store"), str(root / "ev.jsonl")
    store = JobStore(store_dir)
    sched = Scheduler(
        _StubExecutor([{"ok": True}, RuntimeError("stub failure")]), store,
        events=EventLog(events_path), max_retries=0, worker_id="wa")
    sched.start()
    try:
        done = _wait(sched, sched.submit(*_spec(1))["job_id"])
        failed = _wait(sched, sched.submit(*_spec(2))["job_id"])
    finally:
        sched.stop()
    assert (done["status"], failed["status"]) == ("done", "failed")
    spec, x = _spec(3)
    store.save_job({"job_id": "poison1", "status": "quarantined",
                    "fingerprint": store.fingerprint(
                        spec.fingerprint_payload(), x),
                    "attempt": 0, "restart_requeues": 2,
                    "quarantined_at": 1.0, "error": "crash-looped",
                    "shape": [40, 2]})
    store.save_payload("poison1", spec.fingerprint_payload(), x)
    store.set_payload_attempts("poison1", spec.fingerprint_payload(), 2)
    return store_dir, events_path, done["job_id"], failed["job_id"]


def _admin(module, argv, capsys):
    parser = argparse.ArgumentParser()
    module.add_arguments(parser)
    code = module.cmd_serve_admin(parser.parse_args(argv))
    return code, capsys.readouterr().out


def _both(argv, capsys):
    port = _admin(admin, argv, capsys)
    ref = _admin(jax_admin, argv, capsys)
    assert port[0] == ref[0] == 0
    return port[1], ref[1]


def test_list_equals_the_jax_tool(served, capsys):
    store_dir = served[0]
    port, ref = _both(["--store-dir", store_dir, "list"], capsys)
    assert port == ref and port.startswith("poison1  restarts=2")


@pytest.mark.parametrize("which", ["done", "quarantined"])
def test_show_equals_the_jax_tool_but_prices_with_the_port(served, capsys,
                                                          which):
    store_dir, _, done_id, _ = served
    job_id = done_id if which == "done" else "poison1"
    port, ref = _both(["--store-dir", store_dir, "show", job_id], capsys)
    port, ref = json.loads(port), json.loads(ref)
    footprints = port.pop("footprints", None)
    ref.pop("footprints", None)
    assert port == ref
    if which == "done":  # a finished job's payload is gone: no sizes
        assert footprints is None
        return
    kwargs = dict(dtype="float32", h_block=4, subsampling=0.8)
    assert footprints["dense"] == preflight.estimate_job_bytes(
        40, 2, [2, 3], **kwargs)
    assert footprints["packed"] == preflight.estimate_packed_bytes(
        40, 2, [2, 3], n_iterations=12, **kwargs)
    assert footprints["estimator"] == preflight.estimate_estimator_bytes(
        40, 2, [2, 3], n_pairs=None, accum_repr="packed", **kwargs)


@pytest.mark.parametrize("which", ["done", "failed"])
def test_trace_equals_the_jax_tool(served, capsys, which):
    store_dir, events_path, done_id, failed_id = served
    job_id = done_id if which == "done" else failed_id
    port, ref = _both(["--store-dir", store_dir, "trace", job_id,
                       "--events", events_path], capsys)
    assert port == ref and f"trace {job_id}" in port
    assert "queue_wait" in port


def test_report_and_queries_equal_the_jax_tool(served, capsys):
    store_dir, events_path = served[:2]
    port, ref = _both(["--store-dir", store_dir, "report", "--events",
                       events_path], capsys)
    assert port == ref and "per-bucket latency" in port
    assert "done=1" in port and "failed=1" in port
    events = query.load_events(events_path)
    assert events == jax_query.load_events(events_path)
    summary = query.summarize(events, store_dir=store_dir)
    assert summary == jax_query.summarize(events, store_dir=store_dir)
    assert query.render_report(summary) == jax_query.render_report(summary)
    assert query.render_trace(events, served[2]) == jax_query.render_trace(
        events, served[2])


def test_bundle_holds_the_record_and_names_the_port(served, tmp_path,
                                                    capsys):
    store_dir, events_path, done_id, _ = served
    outs = {}
    for name, module in (("port", admin), ("jax", jax_admin)):
        out = str(tmp_path / f"{name}.tar.gz")
        code, _ = _admin(module, ["--store-dir", store_dir, "bundle",
                                  done_id, "--events", events_path,
                                  "--out", out], capsys)
        assert code == 0
        with tarfile.open(out) as tar:
            outs[name] = {m.name: tar.extractfile(m).read()
                          for m in tar.getmembers()}
    assert set(outs["port"]) == set(outs["jax"])
    record = json.loads(outs["port"][f"{done_id}/record.json"])
    with open(os.path.join(store_dir, "jobs", f"{done_id}.json")) as f:
        assert record == json.load(f)
    env = json.loads(outs["port"][f"{done_id}/env.json"])
    assert env["tool"] == "consensus_clustering_tpu_torch serve-admin bundle"
    for name in outs["port"]:
        if not name.endswith(("env.json", "report.json")):
            assert outs["port"][name] == outs["jax"][name], name


def test_release_round_trips_through_the_port_jobstore(served, tmp_path,
                                                       capsys):
    import shutil

    store_dir = str(tmp_path / "store")
    shutil.copytree(served[0], store_dir)
    code, out = _admin(admin, ["--store-dir", store_dir, "release",
                               "poison1"], capsys)
    assert code == 0 and out.startswith("released poison1")
    store = JobStore(store_dir)
    assert store.load_job("poison1")["status"] == "queued"
    payload, x, attempts = store.load_payload("poison1")
    assert attempts == 0 and x.shape == (40, 2)
    code, _ = _admin(admin, ["--store-dir", store_dir, "release",
                             served[2]], capsys)
    assert code == 1
    sched = Scheduler(_StubExecutor(), store, quarantine_after=2)
    sched.start()
    try:
        assert _wait(sched, "poison1")["status"] == "done"
    finally:
        sched.stop()


def test_profile_next_arms_the_port_store(tmp_path, capsys):
    code, out = _admin(admin, ["--store-dir", str(tmp_path), "profile-next",
                               str(tmp_path / "trace")], capsys)
    assert code == 0 and "torch.profiler" in out
    assert JobStore(str(tmp_path)).claim_profile() == str(tmp_path / "trace")


_SUBPROCESS = """
import json, sys
import torch
from consensus_clustering_tpu_torch.cli import main
try:
    main(sys.argv[1:])
    code = 0
except SystemExit as e:
    code = e.code
engine = sorted(m for m in sys.modules
                if m.split(".")[:2][-1] in ("api", "parallel", "ops")
                and m.startswith("consensus_clustering_tpu_torch."))
print(json.dumps({"code": code, "cuda": torch.cuda.is_initialized(),
                  "engine": engine,
                  "jax": any(m == "jax" or m.startswith("jax.")
                             for m in sys.modules)}))
"""


@pytest.mark.parametrize("subcommand",
                         ["list", "show", "trace", "report", "bundle"])
def test_serve_admin_never_touches_the_engine(served, tmp_path, subcommand):
    store_dir, events_path, done_id, _ = served
    args = {
        "list": ["list"],
        "show": ["show", done_id],
        "trace": ["trace", done_id, "--events", events_path],
        "report": ["report", "--events", events_path],
        "bundle": ["bundle", done_id, "--events", events_path, "--out",
                   str(tmp_path / "b.tar.gz")],
    }[subcommand]
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run(
        [sys.executable, "-c", _SUBPROCESS, "serve-admin", "--store-dir",
         store_dir, *args],
        capture_output=True, text=True, cwd=REPO, timeout=120, env=env)
    assert proc.returncode == 0, proc.stderr[-2000:]
    verdict = json.loads(proc.stdout.strip().splitlines()[-1])
    assert verdict == {"code": 0, "cuda": False, "engine": [], "jax": False}
