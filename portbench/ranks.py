"""A cell that spans processes: the launcher and each rank.

``python3 portbench/run.py --workload <cell> ...`` on a cell whose traffic
says ``"processes": n`` calls :func:`launch`, which starts n ranks of this
file, one device each (rank r on card r; the CPU in the tests), and waits
for them.  Each rank joins the program's process group
(``distributed.initialize``, a local coordinator) with the traffic's
backend, builds its mesh (``resample_mesh`` with the traffic's
``k_shards`` and ``row_shards``, every process's devices) and runs
:func:`portbench.harness.run_cell` with its :class:`Group`: the same
sweeps in lockstep, rank 0 deciding before each whether it starts.  Rank 0
writes the result, which the launcher prints as the command's one result
line.

No hang: a rank that exits non-zero ends every rank within a second and
the command exits with its code (137 for a rank killed by a signal); a
run whose set-up has not ended :data:`SETUP_LIMIT_S` after the command
started, or whose window has not ended :data:`GRACE_S` past
``--seconds``, is ended with exit 4.  A rank dies with its launcher.

The coordinator's port is one the launcher found free; another socket
may take it before rank 0 binds it (a rank's own connection, whose local
port the system draws from the same pool).  Rank 0 then exits with
:data:`RENDEZVOUS_FAILED` and the launcher starts every rank again on
another port, up to :data:`RENDEZVOUS_TRIES` times, within the set-up's
limit; the result's notes say how often, since ``setup_s`` then holds the
failed attempts too.  Any other failure to rendezvous, or one of another
rank, ends the run as any error does.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import shutil
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from portbench import harness  # noqa: E402

#: Seconds from the command's start within which every rank has set up
#: (the first run in a checkout builds the kernels: seconds).
SETUP_LIMIT_S = 600.0
#: Seconds past ``--seconds`` within which the window, the check and the
#: ranks' exits are over (a sweep that starts at the end of the window,
#: the traced sweep's reading, the check: under a minute).
GRACE_S = 240.0
_POLL_S = 0.5
#: Rank 0's exit when its coordinator's port was taken (``EADDRINUSE``).
RENDEZVOUS_FAILED = 75
RENDEZVOUS_TRIES = 3
_RESULT = "result.json"
_OPENED = "window_opened"


class Group:
    """This rank's place in a cell across processes (what
    :func:`portbench.harness.run_cell` asks of it)."""

    def __init__(self, rank: int, mesh, run_dir: str):
        self.rank, self.mesh, self.run_dir = rank, mesh, run_dir

    def decide(self, go: bool) -> bool:
        """Rank 0's ``go`` on every rank (the default gloo group)."""
        from consensus_clustering_tpu_torch.parallel import distributed

        return bool(distributed.broadcast_object(bool(go)))

    def gather(self, obj: Any) -> List[Any]:
        """Every rank's ``obj``, in rank order, on every rank."""
        from consensus_clustering_tpu_torch.parallel import distributed

        return distributed.gather_objects(obj)

    def opened(self) -> None:
        """Tell the launcher the window opened (rank 0)."""
        if self.rank == 0:
            _write(self.run_dir, _OPENED, repr(time.monotonic()))
            print("portbench: the window opened", file=sys.stderr,
                  flush=True)


def _write(run_dir: str, name: str, text: str) -> None:
    tmp = os.path.join(run_dir, name + ".tmp")
    with open(tmp, "w") as f:
        f.write(text)
    os.replace(tmp, os.path.join(run_dir, name))


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def launch(cell: Dict[str, Any], seed: int, seconds: float, trace: bool,
           precision: str = "float32", fault: Optional[str] = None,
           device: str = "cuda", t0: Optional[float] = None
           ) -> Tuple[int, Optional[Dict[str, Any]]]:
    """Run ``cell`` as its ranks; (exit code, rank 0's result or None).
    ``t0`` is the command's start on ``time.monotonic``'s clock (the
    start of ``setup_s``)."""
    t0 = time.monotonic() if t0 is None else t0
    world = int(cell["processes"])
    run_dir = tempfile.mkdtemp(prefix="portbench-ranks-")
    command = [
        sys.executable, os.path.abspath(__file__),
        "--workload", cell["name"], "--root", cell["root"],
        "--seed", str(seed), "--seconds", repr(float(seconds)),
        "--trace", str(int(trace)), "--precision", precision,
        "--device", device, "--world", str(world),
        "--run-dir", run_dir, "--t0", repr(t0), "--parent", str(os.getpid()),
    ] + (["--fault", fault] if fault else [])
    procs: List[subprocess.Popen] = []
    main_thread = threading.current_thread() is threading.main_thread()
    ended = signal.getsignal(signal.SIGTERM)

    def on_term(signum, frame):
        raise SystemExit(128 + signum)  # through the ranks' ending below

    if main_thread:
        signal.signal(signal.SIGTERM, on_term)
    try:
        retries = 0
        for _ in range(RENDEZVOUS_TRIES):
            coordinator = ["--coordinator", f"127.0.0.1:{_free_port()}"]
            # A rank's standard output goes to standard error: the
            # launcher's holds the one result line alone.
            procs = []
            for rank in range(world):
                procs.append(subprocess.Popen(
                    command + coordinator + ["--rank", str(rank)], stdout=2))
            print(f"portbench: {world} ranks, pids "
                  f"{[p.pid for p in procs]}", file=sys.stderr, flush=True)
            code = _watch(procs, run_dir, seconds, t0)
            if code != RENDEZVOUS_FAILED:
                break
            retries += 1
            _end(procs)
            print("portbench: the coordinator's port was taken; starting "
                  "the ranks again on another", file=sys.stderr, flush=True)
        result = None
        if code == 0:
            with open(os.path.join(run_dir, _RESULT)) as f:
                result = json.load(f)
            if retries:
                result["notes"].append(
                    f"the ranks started {retries + 1} times, the "
                    f"coordinator's port taken before; setup_s holds the "
                    f"failed starts")
        return code, result
    finally:
        _end(procs)
        if main_thread:
            signal.signal(signal.SIGTERM, ended)
        shutil.rmtree(run_dir, ignore_errors=True)


def _end(procs: List[subprocess.Popen]) -> None:
    for p in procs:
        if p.poll() is None:
            p.kill()
        p.wait()


def _watch(procs: List[subprocess.Popen], run_dir: str, seconds: float,
           t0: float) -> int:
    """Wait for every rank; the first non-zero exit, 4 past the limits,
    or 0 with rank 0's result written."""
    opened = os.path.join(run_dir, _OPENED)
    while True:
        codes = [p.poll() for p in procs]
        for rank, code in enumerate(codes):
            if code not in (None, 0):
                print(f"portbench: rank {rank} exited {code}; ending every "
                      f"rank", file=sys.stderr, flush=True)
                return code if code > 0 else 128 - code
        if all(code == 0 for code in codes):
            if not os.path.isfile(os.path.join(run_dir, _RESULT)):
                print("portbench: the ranks ended without a result",
                      file=sys.stderr)
                return 1
            return 0
        if os.path.isfile(opened):
            with open(opened) as f:
                deadline, what = float(f.read()) + seconds + GRACE_S, (
                    f"{GRACE_S:.0f} s past the window's {seconds:g} s")
        else:
            deadline, what = t0 + SETUP_LIMIT_S, (
                f"set-up past {SETUP_LIMIT_S:.0f} s")
        if time.monotonic() > deadline:
            print(f"portbench: the ranks ran {what}; ending every rank",
                  file=sys.stderr, flush=True)
            return 4
        time.sleep(_POLL_S)


def _die_with_parent(parent: int) -> None:
    """SIGKILL this process when its launcher ends (Linux's
    ``PR_SET_PDEATHSIG``)."""
    import ctypes

    with contextlib.suppress(OSError, AttributeError):
        ctypes.CDLL(None, use_errno=True).prctl(1, signal.SIGKILL)
    if os.getppid() != parent:
        os._exit(1)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="one rank of a cell")
    for name in ("--workload", "--root", "--precision", "--device",
                 "--coordinator", "--run-dir", "--fault"):
        parser.add_argument(name)
    for name in ("--seed", "--trace", "--world", "--rank", "--parent"):
        parser.add_argument(name, type=int)
    for name in ("--seconds", "--t0"):
        parser.add_argument(name, type=float)
    args = parser.parse_args(argv)
    _die_with_parent(args.parent)
    t_start = time.perf_counter() - (time.monotonic() - args.t0)
    harness.set_environment()
    cell = harness.load_cell(args.workload, root=args.root)
    traffic = cell["traffic"]
    import torch

    if args.device == "cuda":
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < max(int(cell["chips"]), args.world):
            print(f"portbench: {args.workload} needs {cell['chips']} CUDA "
                  f"device(s); this machine has {have}", file=sys.stderr)
            return 2
        local = [torch.device("cuda", args.rank)]
    else:
        local = [args.device]
    try:
        from consensus_clustering_tpu_torch.parallel import distributed
        from consensus_clustering_tpu_torch.parallel.mesh import (
            resample_mesh,
        )
    except ImportError as e:
        print(f"portbench: the program is not beside the benchmark: {e}",
              file=sys.stderr)
        return 2
    from portbench import faults

    try:
        distributed.initialize(args.coordinator, num_processes=args.world,
                               process_id=args.rank, local_devices=local)
    except torch.distributed.DistNetworkError as e:
        print(f"portbench: rank {args.rank} could not rendezvous: {e}",
              file=sys.stderr, flush=True)
        if args.rank == 0 and "EADDRINUSE" in str(e):
            return RENDEZVOUS_FAILED
        return 1
    if distributed.backend() != traffic["backend"]:
        print(f"portbench: the ranks merge over {distributed.backend()}, "
              f"the traffic states {traffic['backend']}", file=sys.stderr)
        return 2
    shape = traffic["mesh"]
    if int(shape.get("k_shards", 1)) != 1:
        print("portbench: a cell's mesh has no 'k' shards (the check joins "
              "the ranks' lanes in rank order)", file=sys.stderr)
        return 2
    mesh = resample_mesh(row_shards=int(shape["row_shards"]))
    group = Group(args.rank, mesh, args.run_dir)
    planted = ({**faults.FAULTS, **faults.PROCESS_FAULTS}[args.fault]()
               if args.fault else contextlib.nullcontext())
    with planted:
        result = harness.run_cell(cell, args.seed, args.seconds,
                                  bool(args.trace), device=args.device,
                                  t_start=t_start, precision=args.precision,
                                  group=group)
    loaded = sorted({m for mods in group.gather(harness.forbidden_modules())
                     for m in mods})
    distributed.shutdown()
    if args.rank != 0:
        return 0
    if loaded:
        print(f"portbench: modules of JAX or of the JAX package are loaded: "
              f"{loaded}", file=sys.stderr)
        return 3
    _write(args.run_dir, _RESULT, json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
