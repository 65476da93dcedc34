"""The stream, the estimator and the monolithic sweep across processes.

Real gloo processes on the CPU, started as ``tests/test_torch_distributed.py``
starts them, with ``jax`` poisoned in every worker.  Each layout's engines
run in one process group, and every rank's result must equal the
one-process, one-device run of the same engine bit for bit (curves,
matrices, the pair state, the captured packed state):

- two processes x two CPU devices: (a) ``row_shards=2``, 'h' across the
  processes; (b) ``row_shards=4``, 'n' across them; (c) ``k_shards=2``,
  'k' across them (not the estimator);
- four processes x one device, (1, 2, 2): both axes across the
  processes, in proper subgroups (an all-reduce over every process would
  add row block 0 to row block 1).

In the two-process group also: a stream and an estimator cut at block 2
under two processes resume under one; a one-process frame resumes under
two, where only rank 0 has a ring; rank 0 alone writes frames; a bit
flipped on rank 1 only raises ``IntegrityError`` on both; ``mode="auto"``
under two budgets runs the primary's engine on both (its ``exact_best_k``
refinement the same on both); and the packed
stream on (1, 2, 2) equals the JAX package's ``StreamingSweep`` on 4 of
its 8 virtual devices (co-sample planes and the planes at the blobs'
K bit for bit, PAC in the sweep parity band).
"""

import dataclasses
import json
import os
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest
from jax.sharding import Mesh as JaxMesh

from consensus_clustering_tpu.config import SweepConfig as JaxSweepConfig
from consensus_clustering_tpu.models.kmeans import KMeans as JaxKMeans
from consensus_clustering_tpu.parallel.streaming import (
    StreamingSweep as JaxStreamingSweep,
)
from consensus_clustering_tpu_torch.data import make_blobs
from consensus_clustering_tpu_torch.resilience import InjectedFault, faults
from consensus_clustering_tpu_torch.resilience.blocks import (
    StreamCheckpointer,
)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, H, KS, SEED, PAIRS = 61, 21, (2, 3, 4), 5, 301
REF_N, REF_H = 120, 40

# The engines of every layout: (name, kind, config overrides).
ENGINES = [
    ("stream_dense", "stream", dict(accum_repr="dense")),
    ("stream_packed", "stream", dict(accum_repr="packed", fuse_block="off")),
    ("stream_fused", "stream", dict(accum_repr="packed", fuse_block="on")),
    ("estimate_dense", "estimate", dict(accum_repr="dense")),
    ("estimate_packed", "estimate", dict(accum_repr="packed")),
    ("sweep", "sweep", dict(accum_repr="dense")),
]
# Layout -> (processes, row_shards, k_shards, engines).
LAYOUTS = {
    "a": (2, 2, 1, [e for e, _, _ in ENGINES if e != "sweep"]),
    "b": (2, 4, 1, [e for e, _, _ in ENGINES]),
    "c": (2, 1, 2, [e for e, k, _ in ENGINES if k != "estimate"]),
    "d": (4, 1, 1, [e for e, _, _ in ENGINES]),
}

_COMMON = """
import dataclasses
import numpy as np
from consensus_clustering_tpu_torch.config import SweepConfig
from consensus_clustering_tpu_torch.estimator.engine import PairConsensusEngine
from consensus_clustering_tpu_torch.models.kmeans import KMeans
from consensus_clustering_tpu_torch.parallel.streaming import StreamingSweep
from consensus_clustering_tpu_torch.parallel.sweep import run_sweep

N, H, KS, SEED, PAIRS = %d, %d, %r, %d, %d
ENGINES = %r


def config(**kw):
    base = dict(n_samples=N, n_features=3, k_values=KS, n_iterations=H,
                cluster_batch=4, stream_h_block=8, store_matrices=True)
    base.update(kw)
    return SweepConfig(**base)


def run_engine(name, x, where, **run_kw):
    kind, over = {e: (k, o) for e, k, o in ENGINES}[name]
    if kind == "sweep":
        return run_sweep(KMeans(n_init=2), config(stream_h_block=None,
                                                  **over), x, SEED, **where)
    if kind == "estimate":
        engine = PairConsensusEngine(KMeans(n_init=2), config(
            store_matrices=False, **over), n_pairs=PAIRS, **where)
        return engine.run(x, SEED, H, return_state=True, **run_kw)
    engine = StreamingSweep(KMeans(n_init=2), config(**over), **where)
    return engine.run(x, SEED, H, capture_state=over["accum_repr"] ==
                      "packed", **run_kw)
""" % (N, H, KS, SEED, PAIRS, ENGINES)

_WORKER = """
import json, os, sys
sys.modules["jax"] = None
sys.modules["consensus_clustering_tpu"] = None
import numpy as np
from consensus_clustering_tpu_torch.parallel import distributed
from consensus_clustering_tpu_torch.parallel.mesh import resample_mesh

coord, pid, procs, spec_path = sys.argv[1], *map(int, sys.argv[2:4]), \\
    sys.argv[4]
spec = json.load(open(spec_path))
distributed.initialize(coord, num_processes=procs, process_id=pid,
                       local_devices=["cpu"] * (4 // procs))
""" + _COMMON + """
from consensus_clustering_tpu_torch import ConsensusClustering
from consensus_clustering_tpu_torch.convert import (
    config_from_jax, kmeans_from_jax)
from consensus_clustering_tpu_torch.resilience import faults
from consensus_clustering_tpu_torch.resilience.blocks import (
    StreamCheckpointer)

inputs = np.load(spec["inputs"])
x = inputs["x"]
arrays, meta = {}, {}


def keep(prefix, out):
    for name, value in out.items():
        if isinstance(value, dict):
            keep(f"{prefix}/{name}", value)
        elif isinstance(value, np.ndarray):
            arrays[f"{prefix}/{name}"] = value
    meta[prefix] = {"streaming": out.get("streaming"),
                    "processes": out.get("timing", {}).get("processes")}


for layout, rows, kshards, names in spec["layouts"]:
    mesh = resample_mesh(row_shards=rows, k_shards=kshards)
    assert mesh.process_count == procs
    for name in names:
        keep(f"{layout}/{name}", run_engine(name, x, dict(mesh=mesh)))

if "extras" in spec:
    ex = spec["extras"]
    mesh = resample_mesh(row_shards=2)   # (1, 2, 2): 'h' across processes

    def cut(name, ring):
        faults.configure("block_start=2")
        try:
            run_engine(name, x, dict(mesh=mesh), checkpointer=ring)
            return "ran"
        except Exception as e:
            return type(e).__name__
        finally:
            faults.clear()
            ring.flush()

    for name in ("stream_packed", "estimate_packed"):
        ring = StreamCheckpointer(ex["cut_dirs"][name][pid])
        meta[f"cut/{name}"] = {"raised": cut(name, ring),
                               "writes": ring.writes_total}
        ring.close()
        ring = (StreamCheckpointer(ex["one_dirs"][name]) if pid == 0
                else None)
        keep(f"resume/{name}", run_engine(name, x, dict(mesh=mesh),
                                          checkpointer=ring))
        meta[f"resume/{name}"]["ring_on_rank"] = ring is not None
        if ring is not None:
            ring.close()
    faults.configure("accumulator=1:bitflip" if pid == 1 else None)
    try:
        run_engine("stream_dense", x, dict(mesh=mesh),
                   integrity_check_every=1)
        meta["sentinel"] = {"raised": None}
    except Exception as e:
        meta["sentinel"] = {"raised": type(e).__name__,
                            "block": getattr(e, "block", None)}
    finally:
        faults.clear()
    os.environ["CCTPU_MEMORY_BUDGET"] = ex["budgets"][pid]
    fit = ConsensusClustering(
        K_range=KS, n_iterations=H, random_state=SEED, mesh=mesh,
        mode="auto", store_matrices=False, n_pairs=PAIRS,
        stream_h_block=8, cluster_batch=4, exact_best_k=True,
        plot_cdf=False).fit(x)
    meta["auto"] = {"mode": fit.metrics_.get("mode", "exact"),
                    "auto": fit.metrics_.get("auto"),
                    "processes": fit.metrics_.get("processes"),
                    "refined": {k: v for k, v in fit.metrics_.get(
                        "exact_best_k", {}).items() if k != "timing"}}
    arrays["auto/pac_area"] = np.asarray(
        [fit.cdf_at_K_data[k]["pac_area"] for k in KS])
    ref = json.load(open(ex["reference"]))
    xr = inputs["x_ref"]
    engine = StreamingSweep(kmeans_from_jax(ref["kmeans"]),
                            config_from_jax(ref["config"]), mesh=mesh)
    keep("jax", engine.run(xr, 23, ref["config"]["n_iterations"],
                           capture_state=True))

np.savez(os.path.join(spec["out"], f"rank{pid}.npz"), **arrays)
json.dump(meta, open(os.path.join(spec["out"], f"rank{pid}.json"), "w"))
distributed.shutdown()
"""


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _start_group(procs, spec, tmp):
    """Start ``procs`` single-threaded workers on ``spec``."""
    spec = dict(spec, out=str(tmp))
    spec_path = tmp / "spec.json"
    spec_path.write_text(json.dumps(spec))
    coord = f"127.0.0.1:{_free_port()}"
    env = dict(os.environ, PYTHONPATH=_REPO, OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    env.pop("CCTPU_FAULTS", None)
    return [subprocess.Popen(
        [sys.executable, "-c", _WORKER, coord, str(pid), str(procs),
         str(spec_path)], cwd=_REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for pid in range(procs)]


def _finish_groups(groups):
    """Wait for every group's workers (killing them all on a failure or a
    hang); each group's ranks' (arrays, meta)."""
    try:
        for workers, _ in groups:
            for p in workers:
                _, stderr = p.communicate(timeout=240)
                assert p.returncode == 0, stderr[-4000:]
    finally:
        for workers, _ in groups:
            for p in workers:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    out = []
    for workers, tmp in groups:
        ranks = []
        for pid in range(len(workers)):
            with np.load(tmp / f"rank{pid}.npz") as z:
                arrays = {k: z[k] for k in z.files}
            ranks.append((arrays, json.loads(
                (tmp / f"rank{pid}.json").read_text())))
        out.append(ranks)
    return out


@pytest.fixture(scope="module")
def data():
    x, _ = make_blobs(n_samples=N, n_features=3, centers=3,
                      cluster_std=1.5, random_state=2)
    return x.astype(np.float32)


@pytest.fixture(scope="module")
def scope():
    env = {}
    exec(_COMMON, env)
    return env


def _one_device(data, scope):
    """Every engine's one-process, one-device run, flattened as the
    workers flatten theirs."""
    out = {}
    for name, _, _ in ENGINES:
        _flatten(out, name, scope["run_engine"](name, data,
                                                dict(device="cpu")))
    return out


def _flatten(into, prefix, out):
    for name, value in out.items():
        if isinstance(value, dict):
            _flatten(into, f"{prefix}/{name}", value)
        elif isinstance(value, np.ndarray):
            into[f"{prefix}/{name}"] = value


def _jax_reference(blobs):
    """The JAX package's packed stream on 4 of its 8 virtual devices as
    (h=2, n=2)."""
    x, _ = blobs
    devices = np.asarray(jax.devices()[:4], dtype=object).reshape(1, 2, 2)
    return JaxStreamingSweep(JaxKMeans(**REF_KMEANS),
                             JaxSweepConfig(**REF_CONFIG),
                             mesh=JaxMesh(devices, ("k", "h", "n"))).run(
        x, 23, REF_H, capture_state=True)


REF_CONFIG = dict(n_samples=REF_N, n_features=5, k_values=(2, 3, 4),
                  n_iterations=REF_H, store_matrices=False,
                  stream_h_block=16, accum_repr="packed")
REF_KMEANS = dict(n_init=2)


@pytest.fixture(scope="module")
def groups(tmp_path_factory, data, scope, blobs):
    """Both process groups, run at once: the two-process one (layouts
    (a)-(c) and the extras) and the four-process one (layout (d)); the
    references are computed while they run."""
    tmp = tmp_path_factory.mktemp("groups")
    one_dirs = {}
    for name in ("stream_packed", "estimate_packed"):
        one_dirs[name] = str(tmp / f"one_{name}")
        ring = StreamCheckpointer(one_dirs[name])
        faults.configure("block_start=2")
        try:
            with pytest.raises(InjectedFault):
                scope["run_engine"](name, data, dict(device="cpu"),
                                    checkpointer=ring)
        finally:
            faults.clear()
            ring.close()
    jax_km = dataclasses.asdict(JaxKMeans(**REF_KMEANS))
    jax_config = dataclasses.asdict(JaxSweepConfig(**REF_CONFIG))
    (tmp / "reference.json").write_text(json.dumps(
        {"config": jax_config, "kmeans": jax_km}))
    np.savez(tmp / "inputs.npz", x=data, x_ref=blobs[0])
    extras = {
        "cut_dirs": {name: [str(tmp / f"cut_{name}_{r}") for r in range(2)]
                     for name in ("stream_packed", "estimate_packed")},
        "one_dirs": one_dirs,
        "budgets": ["1000", str(10**15)],
        "reference": str(tmp / "reference.json"),
    }
    started = []
    for procs in (2, 4):
        sub = tmp / f"p{procs}"
        sub.mkdir()
        spec = {"inputs": str(tmp / "inputs.npz"),
                "layouts": [[lay, rows, ks, names] for lay, (p, rows, ks,
                                                             names)
                            in LAYOUTS.items() if p == procs]}
        if procs == 2:
            spec["extras"] = extras
        started.append((_start_group(procs, spec, sub), sub))
    try:
        one = _one_device(data, scope)
        ref = _jax_reference(blobs)
    finally:
        two, four = _finish_groups(started)
    return {"two": two, "four": four, "one": one, "ref": ref,
            "extras": extras}


def _cases():
    return [(lay, name) for lay, (_, _, _, names) in LAYOUTS.items()
            for name in names]


@pytest.mark.parametrize("layout,engine", _cases())
def test_every_rank_equals_one_device(layout, engine, groups):
    ranks = groups["four" if layout == "d" else "two"]
    want = {k[len(engine) + 1:]: v for k, v in groups["one"].items()
            if k.startswith(engine + "/")}
    assert want
    for pid, (arrays, meta) in enumerate(ranks):
        prefix = f"{layout}/{engine}/"
        got = {k[len(prefix):]: v for k, v in arrays.items()
               if k.startswith(prefix)}
        assert sorted(got) == sorted(want), (pid, sorted(got))
        for name, value in want.items():
            np.testing.assert_array_equal(got[name], value,
                                          err_msg=f"rank {pid} {name}")
            assert got[name].dtype == value.dtype, name
        assert meta[f"{layout}/{engine}"]["processes"] == len(ranks)


def test_rank0_alone_writes_frames(groups):
    ranks = groups["two"]
    for name, dirs in groups["extras"]["cut_dirs"].items():
        (_, m0), (_, m1) = ranks
        assert m0[f"cut/{name}"] == {"raised": "InjectedFault",
                                     "writes": 2}, name
        assert m1[f"cut/{name}"] == {"raised": "InjectedFault",
                                     "writes": 0}, name
        assert len(os.listdir(dirs[0])) == 2
        assert os.listdir(dirs[1]) == []


@pytest.mark.parametrize("engine", ["stream_packed", "estimate_packed"])
def test_cut_under_two_processes_resumes_under_one(engine, groups, scope,
                                                   data):
    one_device = groups["one"]
    ring = StreamCheckpointer(groups["extras"]["cut_dirs"][engine][0])
    got = {}
    out = scope["run_engine"](engine, data, dict(device="cpu"),
                              checkpointer=ring)
    ring.close()
    assert out["streaming"]["resumed_from_block"] == 2
    _flatten(got, engine, out)
    for name, value in got.items():
        np.testing.assert_array_equal(value, one_device[name], err_msg=name)


@pytest.mark.parametrize("engine", ["stream_packed", "estimate_packed"])
def test_one_process_frame_resumes_under_two(engine, groups):
    one_device = groups["one"]
    for pid, (arrays, meta) in enumerate(groups["two"]):
        info = meta[f"resume/{engine}"]
        assert info["ring_on_rank"] == (pid == 0)
        assert info["streaming"]["resumed_from_block"] == 2
        assert info["streaming"]["checkpoint_writes"] == (
            1 if pid == 0 else 0)
        prefix = f"resume/{engine}/"
        for name, value in arrays.items():
            if name.startswith(prefix):
                np.testing.assert_array_equal(
                    value, one_device[engine + "/" + name[len(prefix):]],
                    err_msg=f"rank {pid} {name}")


def test_bitflip_on_one_rank_raises_on_both(groups):
    for _, meta in groups["two"]:
        assert meta["sentinel"] == {"raised": "IntegrityError", "block": 1}


def test_auto_runs_the_primary_decision_on_every_rank(groups):
    (a0, m0), (a1, m1) = groups["two"]
    assert m0["auto"]["mode"] == m1["auto"]["mode"] == "estimate"
    assert m0["auto"]["auto"] == m1["auto"]["auto"]
    assert m0["auto"]["auto"]["budget_bytes"] == 1000
    assert m0["auto"]["processes"] == m1["auto"]["processes"] == 2
    # The refinement runs in each process, one device each: the same K
    # and the same exact PAC.
    assert m0["auto"]["refined"] == m1["auto"]["refined"]
    assert m0["auto"]["refined"]["k"] in KS
    np.testing.assert_array_equal(a0["auto/pac_area"], a1["auto/pac_area"])


def test_two_processes_against_the_reference(groups):
    ref = groups["ref"]
    for pid, (arrays, _) in enumerate(groups["two"]):
        np.testing.assert_array_equal(
            arrays["jax/final_state/coplanes"],
            ref["final_state"]["coplanes"].view(np.int32))
        # K = 3, the blobs' count: the labels, so the planes, agree.
        np.testing.assert_array_equal(
            arrays["jax/final_state/planes"][1],
            ref["final_state"]["planes"][1].view(np.int32))
        band = np.maximum(0.02, 0.25 * ref["pac_area"])
        assert (np.abs(arrays["jax/pac_area"] - ref["pac_area"])
                <= band).all(), pid
