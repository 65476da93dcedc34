"""Where the time of a sweep goes on the GPU: layers, kernels, idle share.

    python -m consensus_clustering_tpu_torch.profile_sweep [--ks 2,...,20] [--profile-k 8] [--stream H_BLOCK]
    python -m consensus_clustering_tpu_torch.profile_sweep --ab-ring H_BLOCK [--rounds N]
    python -m consensus_clustering_tpu_torch.profile_sweep --estimate [--h 100] [--profile-k 8]
    python -m consensus_clustering_tpu_torch.profile_sweep --append

Runs the headline configuration of ``chip_smoke.py`` (make_blobs N=5000
d=50, H=500, KMeans(n_init=3), cluster_batch=16, chunk_size=4, seed 23)
after a warm-up, through the monolithic dense sweep or, with ``--stream``,
through the streaming engine (``stream_h_block=H_BLOCK``,
``accum_repr="packed"``, ``fuse_block="auto"``):

1. over ``--ks``, plain, for the wall clock, resamples/s, the kernels'
   launches and the Lloyd loop's counts (``lloyd_lanes``:
   :func:`..models.kmeans.lloyd_counts`, and ``occupancy``, the share of
   each step's lanes still running);
2. for the single K ``--profile-k``, plain and then under
   ``torch.profiler``, for the device time of every kernel, the device
   idle share, 1 - (summed kernel time) / (plain wall clock) (the
   profiler slows the host, not the kernels), and the program's own
   layers: each ``cc.*`` range of :func:`..obs.tracing.region` with its
   host seconds (inclusive and self), the device seconds and kernels
   launched with it innermost, and the idle seconds of the gaps that
   began in it (:func:`range_breakdown`).  One K keeps the trace small.

Prints the card's name and power limit, then one JSON line after part 1
and one after part 2, so a cut run keeps what it measured.  With
``--ab H_BLOCK`` it instead times the monolithic and the streamed sweep in
turns (monolithic, streamed, streamed, monolithic) on the same card and
prints one JSON line; ``--ab-ring H_BLOCK`` times, the same way, the
streamed sweep plain, with the resilience layer on (a checkpoint ring
written every block and the integrity sentinel every block) and with the
ring's writes held until after the run (the driver's side alone), with
the ring's, the host copy's and the sentinel's seconds.  Both print each
run's device busy share as NVML samples it (``nvidia-smi``
``utilization.gpu``); ``--rounds N`` repeats the turns N times.

``--estimate`` does parts 1-2 for the sampled-pair estimator at its own
scale (``chip_smoke.py``'s ``estimate``: the same generator at N=100,000,
H=``--h`` (default 100), blocks of 100, packed pairs, 2^17 pairs, then
the exact refinement of K=8, whose ranges are ``cc.refine.*``); part 1
also samples NVML's busy share.  ``--append`` times the append of
``chip_smoke.py`` (a parent of the headline's first 4,000 rows, H=400,
then all 5,000 rows with 100 new resamples), plain with NVML's busy share
and then once under ``torch.profiler`` for part 2's breakdown: the new
lanes' stream is the ``cc.engine`` range, and the append's other work
(store, staleness, merge, curves) is the busy time no range holds.
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import subprocess
import sys
import tempfile
import time
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

from consensus_clustering_tpu_torch.config import SweepConfig
from consensus_clustering_tpu_torch.data import make_blobs
from consensus_clustering_tpu_torch.models.kmeans import KMeans
from consensus_clustering_tpu_torch.obs.tracing import (
    RANGE_PREFIX,
    recording_ranges,
)
from consensus_clustering_tpu_torch.parallel.streaming import (
    run_streaming_sweep,
)
from consensus_clustering_tpu_torch.parallel.sweep import run_sweep
from consensus_clustering_tpu_torch.resilience.blocks import (
    StreamCheckpointer,
)

#: Rows of the estimator's data (``chip_smoke.py``'s ``estimate``).
ESTIMATE_N = 100_000
#: The append of ``chip_smoke.py``: parent rows and resamples, then all
#: rows and the new resamples, in blocks of APPEND_BLOCK.
APPEND = dict(n_old=4000, h_old=400, n_new=5000, h_new=100, block=100)

_KERNEL_PREFIXES = ("lloyd_", "hist_kernel", "popcount_kernel",
                    "fused_planes_kernel", "fused_merge_kernel",
                    "assign_kernel", "kmeanspp_")


def _kernel_class(name: str) -> str:
    # A template kernel's name starts with its return type: "void f<...>(".
    bare = name[len("void "):] if name.startswith("void ") else name
    for prefix in _KERNEL_PREFIXES:
        if bare.startswith(prefix):
            return bare.split("(")[0].split("<")[0]
    lowered = name.lower()
    if "gemm" in lowered or "cutlass" in lowered or "xmma" in lowered:
        return "cublas gemm"
    return "other (elementwise, reductions, copies)"


class Event(NamedTuple):
    """One event of a kineto trace, as :func:`range_breakdown` reads it."""

    name: str
    kind: str  # "range" (a cc.* range), "launch", "device" or "other"
    start: int  # ns
    end: int  # ns
    corr: int


#: :func:`range_breakdown`'s entry for what no range launched or began.
NO_RANGE = "(no range)"
#: Host calls that put work on the device: their correlation ids tie the
#: device operations to the host range that launched them.
_LAUNCH_CALLS = ("cudaLaunch", "cuLaunch", "cudaMemcpy", "cudaMemset",
                 "cuMemcpy", "cuMemset", "cudaGraphLaunch")


def _is_annotation(event, name: str) -> bool:
    """Whether a kineto event is a user annotation (a host range, or its
    GPU-side shadow), by the event itself where it says, else by the
    name of a range of the program or of the benchmark."""
    says = getattr(event, "is_user_annotation", None)
    if says is not None:
        return bool(says())
    return name.startswith((RANGE_PREFIX, "portbench."))


def trace_events(kineto_results) -> List[Event]:
    """The events of a finished ``torch.profiler`` run
    (``prof.profiler.kineto_results``).  The device side of a host range
    (a GPU user annotation) spans the operations it launched and is not
    an operation itself (``portbench/trace.py``'s ``_kind`` tells one
    by its name alone, and so knows only the benchmark's own ranges)."""
    out = []
    for e in kineto_results.events():
        name = e.name()
        if str(e.device_type()).endswith("CUDA"):
            kind = "other" if _is_annotation(e, name) else "device"
        elif name.startswith(RANGE_PREFIX) and _is_annotation(e, name):
            kind = "range"
        elif name.startswith(_LAUNCH_CALLS):
            kind = "launch"
        else:
            kind = "other"
        start = int(e.start_ns())
        out.append(Event(name, kind, start, start + int(e.duration_ns()),
                         int(e.correlation_id())))
    return out


def _innermost(ranges: List[Event], times: List[int]) -> List[Optional[str]]:
    """The innermost range open at each time (the ranges of one thread
    nest), None where none is.  The rule of ``portbench/trace.py``'s
    ``_innermost``, kept alike so that both read a trace alike: at one
    instant, close before query before open."""
    marks = []
    for i, r in enumerate(ranges):
        marks.append((r.start, 2, i))
        marks.append((r.end, 0, i))
    marks += [(t, 1, j) for j, t in enumerate(times)]
    marks.sort(key=lambda m: (m[0], m[1]))
    stack: List[int] = []
    out: List[Optional[str]] = [None] * len(times)
    for _, what, i in marks:
        if what == 2:
            stack.append(i)
        elif what == 0:
            if i in stack:
                stack.remove(i)
        else:
            out[i] = ranges[stack[-1]].name if stack else None
    return out


def range_breakdown(events: List[Event]) -> Dict[str, Dict[str, float]]:
    """Each ``cc.*`` range's ``calls``, ``host_s`` (summed over its
    calls), ``self_host_s`` (less the ranges directly inside it),
    ``device_s`` and ``kernels`` of the device operations launched with
    it innermost, and ``idle_s`` of the device's gaps that began in it;
    the entry ``NO_RANGE`` holds what no range launched or began.  The
    window is from the first range's start to the last one's end."""
    ranges = sorted((e for e in events if e.kind == "range"),
                    key=lambda e: (e.start, -e.end))
    out: Dict = collections.defaultdict(lambda: dict.fromkeys(
        ("calls", "host_s", "self_host_s", "device_s", "kernels",
         "idle_s"), 0))
    if not ranges:
        return {}
    w0, w1 = ranges[0].start, max(r.end for r in ranges)
    stack: List[Event] = []
    for r in ranges:
        while stack and stack[-1].end <= r.start:
            stack.pop()
        entry = out[r.name]
        entry["calls"] += 1
        entry["host_s"] += (r.end - r.start) * 1e-9
        entry["self_host_s"] += (r.end - r.start) * 1e-9
        if stack:
            out[stack[-1].name]["self_host_s"] -= (r.end - r.start) * 1e-9
        stack.append(r)
    launches = [e for e in events if e.kind == "launch"]
    owner = dict(zip((e.corr for e in launches),
                     _innermost(ranges, [e.start for e in launches])))
    device = sorted((e for e in events if e.kind == "device"
                     and e.end > w0 and e.start < w1),
                    key=lambda e: e.start)
    for e in device:
        entry = out[owner.get(e.corr) or NO_RANGE]
        entry["device_s"] += (e.end - e.start) * 1e-9
        if not e.name.startswith(("Memcpy", "Memset")):
            entry["kernels"] += 1
    gaps, cursor = [], w0
    for e in device:
        if e.start > cursor:
            gaps.append((cursor, e.start))
        cursor = max(cursor, e.end)
    if cursor < w1:
        gaps.append((cursor, w1))
    for (a, b), name in zip(gaps, _innermost(ranges, [a for a, _ in gaps])):
        out[name or NO_RANGE]["idle_s"] += (b - a) * 1e-9
    return dict(out)


class _DeferredRing(StreamCheckpointer):
    """The ring with its writer's work (digest, npz, CRC, disk) held until
    :meth:`drain`, after the run: the driver's side of the ring alone (its
    host copies), with no writer thread beside the run."""

    def __init__(self, directory: str):
        super().__init__(directory)
        self.held = []

    def write_async(self, header, arrays) -> None:
        self.held.append((dict(header), dict(arrays)))

    def drain(self) -> None:
        for item in self.held:
            self._write_one(*item)
        self.held.clear()


def _resilient(km, config, x, deferred=False):
    """One streamed run with a ring written every block and the sentinel
    every block (with ``deferred``, the ring's writes after the run and
    outside its busy samples), through :func:`_sampled`."""
    with tempfile.TemporaryDirectory() as tmp:
        ck = _DeferredRing(tmp) if deferred else StreamCheckpointer(tmp)
        try:
            return _sampled(lambda: run_streaming_sweep(
                km, dataclasses.replace(config, integrity_check_every=1),
                x, 23, checkpointer=ck))
        finally:
            if deferred:
                ck.drain()
            ck.close()


def _sampled(run):
    """``run()`` with NVML's ``utilization.gpu`` (the share of each ~0.1 s
    sample in which a kernel ran) read by ``nvidia-smi`` beside it: its
    output and the mean share over the run."""
    smi = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=utilization.gpu",
         "--format=csv,noheader,nounits", "-lms", "100"],
        stdout=subprocess.PIPE, text=True)
    try:
        out = run()
    finally:
        smi.terminate()
        text, _ = smi.communicate(timeout=30)
    samples = [float(v) for v in text.split() if v.isdigit()]
    return out, sum(samples) / len(samples) / 100 if samples else None


def _ab(km, config, x, h_block, ring, rounds=1):
    """Engines in turns (first, second, ..., second, first, ``rounds``
    times): run seconds, launches and whether the curves agree.  Without
    ``ring``: monolithic dense against streamed packed; with it: streamed
    packed plain, with a checkpoint ring and the sentinel every block (its
    ``streaming`` resilience seconds beside), and the same with the ring's
    writes held until after the run.  Each run also carries the device's
    busy share as NVML samples it (:func:`_sampled`)."""
    streamed = dataclasses.replace(config, stream_h_block=h_block,
                                   accum_repr="packed", fuse_block="auto")
    run_sweep(km, dataclasses.replace(config, k_values=(2, 3),
                                      n_iterations=32), x, 23)  # warm-up

    if ring:
        engines = [
            ("streamed", lambda: _sampled(
                lambda: run_streaming_sweep(km, streamed, x, 23))),
            ("streamed+ring+sentinel",
             lambda: _resilient(km, streamed, x)),
            ("streamed+ring+sentinel, writes after the run",
             lambda: _resilient(km, streamed, x, deferred=True)),
        ]
    else:
        engines = [
            ("monolithic", lambda: _sampled(
                lambda: run_sweep(km, config, x, 23))),
            ("streamed", lambda: _sampled(
                lambda: run_streaming_sweep(km, streamed, x, 23))),
        ]
    runs = []
    for _ in range(rounds):
        for name, run in engines + engines[::-1]:
            out, busy = run()
            runs.append({"engine": name,
                         "run_seconds": out["timing"]["run_seconds"],
                         "nvml_busy_share": busy,
                         "launches": out["timing"]["kernel_launches"],
                         "pac_area": out["pac_area"].tolist()})
            if name != "streamed" and ring:
                runs[-1]["resilience_seconds"] = {
                    key: out["streaming"][key] for key in (
                        "checkpoint_copy_seconds",
                        "checkpoint_write_seconds", "integrity_seconds",
                        "checkpoint_writes", "integrity_checks")}

    def median(key):
        return {name: float(np.median([r[key] for r in runs
                                       if r["engine"] == name]))
                for name, _ in engines}

    line = {
        "profile": " vs ".join(name for name, _ in engines) + ", in turns",
        "h": config.n_iterations,
        "k_values": list(config.k_values), "stream_h_block": h_block,
        "rounds": rounds,
        "nvidia_smi": _smi(), "device": torch.cuda.get_device_name(0),
        "runs": runs, "median_run_seconds": median("run_seconds"),
        "median_nvml_busy_share": median("nvml_busy_share"),
        "pac_equal": all(r["pac_area"] == runs[0]["pac_area"] for r in runs),
    }
    print(json.dumps(line, default=float), flush=True)
    return 0


def _estimate_run(km, config, x, seed):
    """The estimator over ``config`` and the exact refinement of K=8 (the
    blobs' count) at the resamples it ran: ``timing.run_seconds`` sums
    both."""
    from consensus_clustering_tpu_torch.estimator.engine import (
        run_pair_estimate,
    )
    from consensus_clustering_tpu_torch.estimator.tiled import (
        exact_curves_for_k,
    )

    out = run_pair_estimate(km, config, x, seed)
    t0 = time.perf_counter()
    refined = dataclasses.replace(
        config, n_iterations=out["streaming"]["h_effective"])
    if 8 in config.k_values:
        lloyd = exact_curves_for_k(km, refined, x, seed, 8)["timing"]["lloyd"]
        out["timing"]["lloyd"] = {name: n + lloyd[name] for name, n
                                  in out["timing"]["lloyd"].items()}
    torch.cuda.synchronize()
    out["timing"]["run_seconds"] += time.perf_counter() - t0
    return out


def _estimate(km, args, smi):
    """``--estimate``: parts 1-2 for the estimator (module docstring)."""
    ks = tuple(int(k) for k in args.ks.split(","))
    n = ESTIMATE_N
    x, _ = make_blobs(n_samples=n, n_features=50, centers=8,
                      cluster_std=3.0, random_state=0)
    x = x.astype(np.float32)
    config = SweepConfig(
        n_samples=n, n_features=50, k_values=ks, n_iterations=args.h,
        store_matrices=False, chunk_size=4, cluster_batch=16,
        stream_h_block=100, accum_repr="packed")
    _estimate_run(km, dataclasses.replace(config, k_values=(2, 8),
                                          n_iterations=16), x, 23)  # warm
    out, busy = _sampled(lambda: _estimate_run(km, config, x, 23))
    plain = out["timing"]
    print(json.dumps({
        "profile": "estimate (N=100,000, packed pairs, refine K=8)",
        "k_values": list(ks), "h": args.h, "n_pairs": 2**17,
        "nvidia_smi": smi, "device": torch.cuda.get_device_name(0),
        "run_seconds": plain["run_seconds"], "nvml_busy_share": busy,
        "peak_device_bytes": plain["device_memory"].get("peak_bytes_in_use"),
        "launches": plain["kernel_launches"],
        "lloyd_lanes": _lloyd_lanes(plain["lloyd"]),
    }, default=float), flush=True)
    _profile_one_k(km, dataclasses.replace(config, k_values=(args.profile_k,)),
                   x, _estimate_run, "estimate", smi, args)
    return 0


def _append(km, args, smi):
    """``--append``: the append of ``chip_smoke.py``, plain then by stage
    (module docstring)."""
    import shutil

    from consensus_clustering_tpu_torch.append import engine as app
    from consensus_clustering_tpu_torch.append.store import PlaneStore

    a = APPEND
    x, _ = make_blobs(n_samples=a["n_new"], n_features=50, centers=8,
                      cluster_std=3.0, random_state=0)
    x = x.astype(np.float32)
    config = SweepConfig(
        n_samples=a["n_old"], n_features=50,
        k_values=tuple(int(k) for k in args.ks.split(",")),
        n_iterations=a["h_old"], store_matrices=False, chunk_size=4,
        cluster_batch=16, stream_h_block=a["block"], accum_repr="packed",
        fuse_block="auto")
    with tempfile.TemporaryDirectory() as tmp:
        parent = f"{tmp}/parent"
        app.bootstrap_generation(x[:a["n_old"]], config=config, clusterer=km,
                                 seed=23, store=PlaneStore(parent))

        def run():
            target = tempfile.mkdtemp(dir=tmp)
            shutil.rmtree(target)
            shutil.copytree(parent, target)
            out = app.run_append(PlaneStore(target), x, h_new=a["h_new"],
                                 clusterer=km, stream_h_block=a["block"])
            # The whole append is the timed run; the new lanes' stream is a
            # part of it.
            out["timing"] = dict(
                out["timing"], stream_run_seconds=out["timing"]["run_seconds"],
                run_seconds=out["append"]["run_seconds"])
            return out

        run()  # warm
        out, busy = _sampled(run)
        print(json.dumps({
            "profile": "append (packed, fused)", "append": a,
            "k_values": list(config.k_values),
            "nvidia_smi": smi, "device": torch.cuda.get_device_name(0),
            "run_seconds": out["append"]["run_seconds"],
            "stream_run_seconds": out["timing"]["stream_run_seconds"],
            "nvml_busy_share": busy,
            "launches": out["timing"]["kernel_launches"],
            "lloyd_lanes": _lloyd_lanes(out["timing"]["lloyd"]),
        }, default=float), flush=True)
        _profile_run(run, out["append"]["run_seconds"],
                     {"profile": "append under torch.profiler"}, smi)
    return 0


def _lloyd_lanes(lloyd: Dict[str, int]) -> Dict[str, float]:
    """A run's Lloyd loop counts, and the share of each step's lanes
    still running."""
    return dict(lloyd, occupancy=lloyd["lane_steps"]
                / max(lloyd["lane_slots"], 1))


def _profile_one_k(km, one_k, x, run, engine, smi, args):
    """Part 2 (module docstring): one K plain, then under torch.profiler."""
    plain = run(km, one_k, x, 23)["timing"]["run_seconds"]
    _profile_run(lambda: run(km, one_k, x, 23), plain, {
        "profile": f"one K under torch.profiler ({engine})", "h": args.h,
        "stream_h_block": args.stream, "profile_k": args.profile_k}, smi)


def _profile_run(run, plain_seconds, line, smi):
    """``run()`` under torch.profiler: device time by kernel class, the
    device idle share against ``plain_seconds`` (the same run
    unprofiled) and :func:`range_breakdown`; prints one JSON line."""
    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    with recording_ranges(), \
            torch.profiler.profile(activities=activities) as prof:
        run()
    events = trace_events(prof.profiler.kineto_results)
    by_name = collections.defaultdict(lambda: [0, 0.0])
    for e in events:
        if e.kind == "device":
            by_name[e.name][0] += 1
            by_name[e.name][1] += (e.end - e.start) * 1e-9
    by_class = collections.defaultdict(lambda: [0, 0.0])
    for name, (calls, seconds) in by_name.items():
        entry = by_class[_kernel_class(name)]
        entry[0] += calls
        entry[1] += seconds
    busy_s = sum(v[1] for v in by_class.values())
    ranges = range_breakdown(events)
    print(json.dumps({
        **line, "nvidia_smi": smi, "device": torch.cuda.get_device_name(0),
        "run_seconds": plain_seconds, "device_busy_seconds": busy_s,
        "device_idle_share": 1.0 - busy_s / plain_seconds,
        "device_seconds_by_kernel_class": {
            k: {"launches": v[0], "seconds": v[1]}
            for k, v in sorted(by_class.items(), key=lambda kv: -kv[1][1])
        },
        "top_kernels": [
            {"name": name[:80], "calls": v[0], "device_s": v[1]}
            for name, v in sorted(by_name.items(),
                                  key=lambda kv: -kv[1][1])[:8]
        ],
        "ranges": dict(sorted(ranges.items(),
                              key=lambda kv: -kv[1]["host_s"])),
    }, default=float), flush=True)


def _smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
    ).stdout.strip()


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--ks", default=",".join(map(str, range(2, 21))))
    parser.add_argument("--profile-k", type=int, default=8)
    parser.add_argument("--h", type=int, default=None,
                        help="resamples (default 500; --estimate: 100)")
    parser.add_argument("--stream", type=int, default=None, metavar="H_BLOCK")
    parser.add_argument("--ab", type=int, default=None, metavar="H_BLOCK")
    parser.add_argument("--ab-ring", type=int, default=None,
                        metavar="H_BLOCK")
    parser.add_argument("--rounds", type=int, default=1)
    parser.add_argument("--estimate", action="store_true")
    parser.add_argument("--append", action="store_true")
    args = parser.parse_args(argv)
    if args.h is None:
        args.h = 100 if args.estimate else 500
    if not torch.cuda.is_available():
        print("profile_sweep: no CUDA device is visible", file=sys.stderr)
        return 2
    if args.estimate or args.append:
        smi = _smi()
        print(smi, flush=True)
        if args.estimate:
            return _estimate(KMeans(n_init=3), args, smi)
        return _append(KMeans(n_init=3), args, smi)
    ks = tuple(int(k) for k in args.ks.split(","))
    x, _ = make_blobs(n_samples=5000, n_features=50, centers=8,
                      cluster_std=3.0, random_state=0)
    x = x.astype(np.float32)
    engine = "monolithic" if args.stream is None else "stream"
    config = SweepConfig(
        n_samples=5000, n_features=50, k_values=ks, n_iterations=args.h,
        store_matrices=False, chunk_size=4, cluster_batch=16,
    )
    if args.stream is not None:
        config = dataclasses.replace(
            config, stream_h_block=args.stream, accum_repr="packed",
            fuse_block="auto",
        )
    run = run_sweep if args.stream is None else run_streaming_sweep
    km = KMeans(n_init=3)
    if args.ab is not None or args.ab_ring is not None:
        return _ab(km, config, x, args.ab or args.ab_ring,
                   ring=args.ab_ring is not None, rounds=args.rounds)
    # Warm-up: build the kernels and let cuBLAS pick its algorithms.
    run(km, dataclasses.replace(config, k_values=(2, 3),
                                n_iterations=min(args.h, 32)), x, 23)
    smi = _smi()
    print(smi, flush=True)
    plain = run(km, config, x, 23)["timing"]
    print(json.dumps({
        "profile": f"headline ({engine})", "k_values": list(ks),
        "h": args.h, "stream_h_block": args.stream,
        "nvidia_smi": smi, "device": torch.cuda.get_device_name(0),
        "run_seconds": plain["run_seconds"],
        "resamples_per_second": plain["resamples_per_second"],
        "launches": plain["kernel_launches"],
        "lloyd_lanes": _lloyd_lanes(plain["lloyd"]),
    }, default=float), flush=True)

    _profile_one_k(km, dataclasses.replace(config, k_values=(args.profile_k,)),
                   x, run, engine, smi, args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
