"""The port's multi-process bootstrap with real processes on the CPU.

Processes join a gloo group over a local coordinator
(``parallel/distributed.initialize``) and run the monolithic sweep on the
4-device global mesh with 'h' across them: two processes with two CPU
devices each and ``row_shards=2`` (the reference's
``tests/test_distributed.py`` layout), and four with one device each.
Every process must return the same curves and matrices, equal bit for bit
to a one-process run, and the stream, the estimator and meshes whose 'k'
or 'n' axis spans the processes must build there
(``tests/test_torch_distributed_engines.py`` runs them).  The workers run
with ``jax`` poisoned: the port's distributed path imports none of it.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from consensus_clustering_tpu_torch.config import SweepConfig
from consensus_clustering_tpu_torch.models.kmeans import KMeans
from consensus_clustering_tpu_torch.parallel import distributed
from consensus_clustering_tpu_torch.parallel.sweep import run_sweep

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_COMMON = """
import numpy as np
from consensus_clustering_tpu_torch.config import SweepConfig
rng = np.random.default_rng(3)
x = np.concatenate([rng.normal(size=(15, 4)), rng.normal(size=(15, 4)) + 1.0]
                   ).astype(np.float32)
config = SweepConfig(n_samples=30, n_features=4, k_values=(2, 3),
                     n_iterations=11, store_matrices=True)
"""

_WORKER = """
import json, sys
sys.modules["jax"] = None
sys.modules["consensus_clustering_tpu"] = None
from consensus_clustering_tpu_torch.parallel import distributed
from consensus_clustering_tpu_torch.parallel.mesh import resample_mesh

coord, pid, procs, rows = sys.argv[1], *map(int, sys.argv[2:5])
distributed.initialize(coord, num_processes=procs, process_id=pid,
                       local_devices=["cpu"] * (4 // procs))
distributed.initialize(coord, num_processes=procs, process_id=pid)  # again
assert distributed.process_count() == procs
assert distributed.process_index() == pid
assert distributed.is_primary() == (pid == 0)
assert distributed.backend() == "gloo"
assert len(distributed.devices()) == 4
""" + _COMMON + """
from consensus_clustering_tpu_torch.estimator.engine import PairConsensusEngine
from consensus_clustering_tpu_torch.models.kmeans import KMeans
from consensus_clustering_tpu_torch.parallel.streaming import StreamingSweep
from consensus_clustering_tpu_torch.parallel.sweep import run_sweep

mesh = resample_mesh(row_shards=rows)  # every process's devices
assert mesh.shape == {"k": 1, "h": 4 // rows, "n": rows}
assert mesh.process_count == procs
out = run_sweep(KMeans(n_init=2), config, x, 0, mesh=mesh)
built = []
import dataclasses
streamed = dataclasses.replace(config, stream_h_block=4,
                               store_matrices=False)
# Every engine builds across processes, on meshes whose 'k' or 'n' axis
# spans them too (built collectively: each makes its groups).
for build in (lambda: StreamingSweep(KMeans(), streamed, mesh=mesh),
              lambda: PairConsensusEngine(KMeans(), streamed, mesh=mesh),
              lambda: resample_mesh(row_shards=2, k_shards=2),
              lambda: resample_mesh(row_shards=4)):
    made = build()
    built.append(getattr(made, "mesh", made).process_count == procs)
print("RESULT " + json.dumps({
    "pid": pid, "built": built,
    **{k: out[k].tolist() for k in ("pac_area", "hist", "cdf", "mij",
                                     "iij")},
}), flush=True)
distributed.shutdown()
"""


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _result(stdout):
    line = next(ln for ln in stdout.splitlines() if ln.startswith("RESULT "))
    return json.loads(line[len("RESULT "):])


@pytest.mark.parametrize("n_procs,row_shards", [(2, 2), (4, 1)])
def test_processes_equal_one_process(n_procs, row_shards):  # jaxlint: disable=JL018 -- CPU port only, N=30, H=11 in 2-4 subprocesses
    coord = f"127.0.0.1:{_free_port()}"
    env = dict(os.environ, PYTHONPATH=_REPO)
    env.pop("XLA_FLAGS", None)
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WORKER, coord, str(pid), str(n_procs),
         str(row_shards)], cwd=_REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
        for pid in range(n_procs)]
    outs = []
    try:
        for p in procs:
            stdout, stderr = p.communicate(timeout=180)
            assert p.returncode == 0, stderr[-3000:]
            outs.append(_result(stdout))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    scope = {}
    exec(_COMMON, scope)
    one = run_sweep(KMeans(n_init=2), scope["config"], scope["x"], 0,
                    device="cpu")
    for got in outs:
        assert got["built"] == [True, True, True, True]
        for name in ("pac_area", "hist", "cdf", "mij", "iij"):
            want = one[name]
            np.testing.assert_array_equal(
                np.asarray(got[name], dtype=want.dtype), want, err_msg=name)
    assert all(o["pac_area"] == outs[0]["pac_area"] for o in outs)


def test_single_process_initialize_is_a_no_op():
    distributed.initialize("127.0.0.1:1", num_processes=1, process_id=0)
    assert not distributed.is_initialized()
    assert distributed.process_index() == 0
    assert distributed.process_count() == 1
    assert distributed.is_primary()
    assert distributed.backend() is None
    config = SweepConfig(n_samples=8, n_features=2, k_values=(2,),
                         n_iterations=2)
    assert config.k_interleave is False
