"""Where the time of a sweep goes on the GPU: stages, kernels, idle share.

    python -m consensus_clustering_tpu_torch.profile_sweep [--ks 2,...,20] [--profile-k 8] [--stream H_BLOCK]
    python -m consensus_clustering_tpu_torch.profile_sweep --ab-ring H_BLOCK [--rounds N]
    python -m consensus_clustering_tpu_torch.profile_sweep --estimate [--h 100] [--profile-k 8]
    python -m consensus_clustering_tpu_torch.profile_sweep --append

Runs the headline configuration of ``chip_smoke.py`` (make_blobs N=5000
d=50, H=500, KMeans(n_init=3), cluster_batch=16, chunk_size=4, seed 23)
after a warm-up, through the monolithic dense sweep or, with ``--stream``,
through the streaming engine (``stream_h_block=H_BLOCK``,
``accum_repr="packed"``, ``fuse_block="auto"``), whose stages split into
clustering, packing (B4) and evaluation (B3, then B1 from the counts):

1. over ``--ks``, plain, for the wall clock and resamples/s;
2. over ``--ks``, with each stage of the sweep wrapped, from here, in a
   timer that synchronises the device before and after (the library
   carries no instrumentation), for the wall seconds of every stage
   (inclusive: ``cluster`` holds its ``cluster/*`` parts), and the
   Lloyd steps counted by their active lanes and by the lanes a block of
   B2 takes (``lloyd_lanes``);
3. for the single K ``--profile-k``, plain and then under
   ``torch.profiler``, for the device time of every kernel and the
   device idle share, 1 - (summed kernel time) / (plain wall clock): the
   profiler slows the host, not the kernels.  One K keeps the trace
   small, because reducing it on the host (``key_averages``) takes far
   longer than the run it traces.

Prints the card's name and power limit, then one JSON line after parts 1
and 2 and one after part 3, so a cut run keeps what it measured.  With
``--ab H_BLOCK`` it instead times the monolithic and the streamed sweep in
turns (monolithic, streamed, streamed, monolithic) on the same card and
prints one JSON line; ``--ab-ring H_BLOCK`` times, the same way, the
streamed sweep plain, with the resilience layer on (a checkpoint ring
written every block and the integrity sentinel every block) and with the
ring's writes held until after the run (the driver's side alone), with
the ring's, the host copy's and the sentinel's seconds.  Both print each
run's device busy share as NVML samples it (``nvidia-smi``
``utilization.gpu``); ``--rounds N`` repeats the turns N times.

``--estimate`` does parts 1-3 for the sampled-pair estimator at its own
scale (``chip_smoke.py``'s ``estimate``: the same generator at N=100,000,
H=``--h`` (default 100), blocks of 100, packed pairs, 2^17 pairs, then
the exact refinement of K=8): stages plan, the pairs' Iij and Mij
increments, clustering, the pair histogram, and the refinement's label
collection and tiles (B3, B1); part 1 also samples NVML's busy share.
``--append`` times the append of ``chip_smoke.py`` (a parent of the
headline's first 4,000 rows, H=400, then all 5,000 rows with 100 new
resamples), plain with NVML's busy share and then by stage: the new
lanes' stream (and its stages), store load and verify, staleness, merge,
Iij accounting, the merged curves and the store write.  Needs a CUDA
device.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import functools
import json
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from consensus_clustering_tpu_torch.config import SweepConfig
from consensus_clustering_tpu_torch.data import make_blobs
from consensus_clustering_tpu_torch.models import kmeans
from consensus_clustering_tpu_torch.models.kmeans import KMeans
from consensus_clustering_tpu_torch.ops import tiles
from consensus_clustering_tpu_torch.ops.fused_block import lanes_per_block
from consensus_clustering_tpu_torch.parallel import streaming, sweep
from consensus_clustering_tpu_torch.parallel.streaming import (
    run_streaming_sweep,
)
from consensus_clustering_tpu_torch.parallel.sweep import run_sweep
from consensus_clustering_tpu_torch.resilience.blocks import (
    StreamCheckpointer,
)

_CLUSTER_STAGES = (
    (kmeans, "_kmeanspp_init", "cluster/kmeans++"),
    (kmeans, "lloyd_step", "cluster/lloyd_step"),
    (kmeans, "_apply_update", "cluster/update"),
    (kmeans, "assign_labels", "cluster/final_assign"),
)
# (module, attribute, stage name): the stages of each engine.
_STAGES = {
    "monolithic": (
        (sweep, "resample_indices", "plan"),
        (sweep, "cosample_counts", "iij"),
        (sweep, "fit_resample_lanes", "cluster"),
        *_CLUSTER_STAGES,
        (sweep, "coassociation_counts", "mij"),
        (sweep, "consensus_matrix", "cij"),
        (sweep, "consensus_hist_counts", "hist"),
        (sweep, "cdf_pac_from_counts", "curves"),
    ),
    "stream": (
        (streaming, "resample_indices", "plan"),
        (streaming, "pack_cosample_planes", "coplanes"),
        (sweep, "fit_resample_lanes", "cluster"),
        *_CLUSTER_STAGES,
        (streaming, "fused_assign_pack", "pack (B4)"),
        (streaming, "pack_label_planes", "pack (unfused)"),
        (tiles, "packed_coassoc_counts", "popcount (B3)"),
        (tiles, "consensus_hist_from_counts", "cij+hist (B1)"),
        (sweep, "cdf_pac_from_counts", "curves"),
    ),
}

#: Rows of the estimator's data (``chip_smoke.py``'s ``estimate``).
ESTIMATE_N = 100_000
#: The append of ``chip_smoke.py``: parent rows and resamples, then all
#: rows and the new resamples, in blocks of APPEND_BLOCK.
APPEND = dict(n_old=4000, h_old=400, n_new=5000, h_new=100, block=100)

_KERNEL_PREFIXES = ("lloyd_", "hist_kernel", "popcount_kernel",
                    "fused_planes_kernel", "fused_merge_kernel",
                    "assign_kernel")


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


def _self_device_us(event) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        value = getattr(event, attr, None)
        if value is not None:
            return float(value)
    return 0.0


def _timed_stages(km, config, x, run, stages):
    """Stage seconds and calls of one run, and the Lloyd steps' lanes:
    how many steps ran each number of active lanes, and the steps and
    seconds at each lanes-per-block of B2's grid."""
    seconds = collections.defaultdict(float)
    calls = collections.Counter()
    lanes_hist = collections.Counter()
    per_block = collections.defaultdict(lambda: [0, 0.0])
    originals = [(m, a, getattr(m, a)) for m, a, _ in stages]

    def timed(fn, name):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            seconds[name] += dt
            calls[name] += 1
            if name == "cluster/lloyd_step":
                xs, lane_src = args[0], args[1]
                lanes = int(lane_src.shape[0])
                lanes_hist[lanes] += 1
                entry = per_block[lanes_per_block(lanes, xs.shape[0],
                                                  xs.shape[1])]
                entry[0] += 1
                entry[1] += dt
            return out
        return wrapper

    for module, attr, name in stages:
        setattr(module, attr, timed(getattr(module, attr), name))
    try:
        wall = run(km, config, x, 23)["timing"]["run_seconds"]
    finally:
        for module, attr, fn in originals:
            setattr(module, attr, fn)
    lloyd_lanes = {
        "steps_by_active_lanes": dict(sorted(lanes_hist.items())),
        "by_lanes_per_block": {
            p: {"steps": v[0], "seconds": v[1]}
            for p, v in sorted(per_block.items())
        },
    }
    return wall, {n: {"calls": calls[n], "seconds": seconds[n]}
                  for _, _, n in stages}, lloyd_lanes


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
        exact_curves_for_k(km, refined, x, seed, 8)
    torch.cuda.synchronize()
    out["timing"]["run_seconds"] += time.perf_counter() - t0
    return out


def _estimate(km, args, smi):
    """``--estimate``: parts 1-3 for the estimator (module docstring)."""
    from consensus_clustering_tpu_torch.estimator import engine, tiled

    ks = tuple(int(k) for k in args.ks.split(","))
    n = ESTIMATE_N
    x, _ = make_blobs(n_samples=n, n_features=50, centers=8,
                      cluster_std=3.0, random_state=0)
    x = x.astype(np.float32)
    config = SweepConfig(
        n_samples=n, n_features=50, k_values=ks, n_iterations=args.h,
        store_matrices=False, chunk_size=4, cluster_batch=16,
        stream_h_block=100, accum_repr="packed")
    stages = (
        (engine, "resample_indices", "plan"),
        (engine.PairConsensusEngine, "_iij_increment", "iij at the pairs"),
        (sweep, "fit_resample_lanes", "cluster"),
        *_CLUSTER_STAGES,
        (engine.PairConsensusEngine, "_mij_increment", "mij at the pairs"),
        (engine, "masked_histogram_counts", "pair histogram"),
        (tiled, "collect_resample_labels", "refine/collect labels"),
        (tiled, "packed_hist_counts", "refine/tiles (B3, B1)"),
    )
    _estimate_run(km, dataclasses.replace(config, k_values=(2, 8),
                                          n_iterations=16), x, 23)  # warm
    out, busy = _sampled(lambda: _estimate_run(km, config, x, 23))
    plain = out["timing"]
    timed_wall, stage_s, lloyd_lanes = _timed_stages(km, config, x,
                                                     _estimate_run, stages)
    print(json.dumps({
        "profile": "estimate stages (N=100,000, packed pairs, refine K=8)",
        "k_values": list(ks), "h": args.h, "n_pairs": 2**17,
        "nvidia_smi": smi, "device": torch.cuda.get_device_name(0),
        "run_seconds": plain["run_seconds"], "nvml_busy_share": busy,
        "peak_device_bytes": plain["device_memory"].get("peak_bytes_in_use"),
        "launches": plain["kernel_launches"],
        "timed_run_seconds": timed_wall, "stage_seconds": stage_s,
        "lloyd_lanes": lloyd_lanes,
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

        def run(km_, _config, _x, _seed):
            target = tempfile.mkdtemp(dir=tmp)
            shutil.rmtree(target)
            shutil.copytree(parent, target)
            out = app.run_append(PlaneStore(target), x, h_new=a["h_new"],
                                 clusterer=km_, stream_h_block=a["block"])
            # The whole append is the timed run; the new lanes' stream is a
            # part of it.
            out["timing"] = dict(
                out["timing"], stream_run_seconds=out["timing"]["run_seconds"],
                run_seconds=out["append"]["run_seconds"])
            return out

        run(km, None, None, None)  # warm
        out, busy = _sampled(lambda: run(km, None, None, None))
        stages = (
            (PlaneStore, "load_latest", "store load + verify"),
            (app, "_stream", "new lanes (packed stream)"),
            *_STAGES["stream"],
            (app, "staleness_report", "staleness (B3, B1)"),
            (app, "merge_generations", "merge (host numpy)"),
            (app, "iij_accounting_holds", "Iij accounting (B3)"),
            (app, "curves_for_planes", "merged curves (B3, B1)"),
            (PlaneStore, "write_generation", "store write"),
        )
        timed_wall, stage_s, _ = _timed_stages(km, None, None, run, stages)
    print(json.dumps({
        "profile": "append stages (packed, fused)", "append": a,
        "k_values": list(config.k_values),
        "nvidia_smi": smi, "device": torch.cuda.get_device_name(0),
        "run_seconds": out["append"]["run_seconds"],
        "stream_run_seconds": out["timing"]["stream_run_seconds"],
        "nvml_busy_share": busy, "launches": out["timing"]["kernel_launches"],
        "timed_run_seconds": timed_wall, "stage_seconds": stage_s,
    }, default=float), flush=True)
    return 0


def _profile_one_k(km, one_k, x, run, engine, smi, args):
    """Part 3 (module docstring): one K plain, then under torch.profiler:
    device time by kernel class and the device idle share."""
    one_k_plain = run(km, one_k, x, 23)["timing"]["run_seconds"]
    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        run(km, one_k, x, 23)
    kernels = [e for e in prof.key_averages() if _self_device_us(e) > 0
               and e.device_type == torch.autograd.DeviceType.CUDA]
    by_class = collections.defaultdict(lambda: [0, 0.0])
    for e in kernels:
        entry = by_class[_kernel_class(e.key)]
        entry[0] += e.count
        entry[1] += _self_device_us(e) / 1e6
    busy_s = sum(v[1] for v in by_class.values())
    print(json.dumps({
        "profile": f"one K under torch.profiler ({engine})", "h": args.h,
        "stream_h_block": args.stream,
        "nvidia_smi": smi, "device": torch.cuda.get_device_name(0),
        "profile_k": args.profile_k,
        "profile_k_run_seconds": one_k_plain,
        "profile_k_device_busy_seconds": busy_s,
        "profile_k_device_idle_share": 1.0 - busy_s / one_k_plain,
        "device_seconds_by_kernel_class": {
            k: {"launches": v[0], "seconds": v[1]}
            for k, v in sorted(by_class.items(), key=lambda kv: -kv[1][1])
        },
        "top_kernels": [
            {"name": e.key[:80], "calls": e.count,
             "device_s": _self_device_us(e) / 1e6}
            for e in sorted(kernels, key=lambda e: -_self_device_us(e))
            [:8]
        ],
    }, default=float))


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
    timed_wall, stages, lloyd_lanes = _timed_stages(km, config, x, run,
                                                    _STAGES[engine])
    print(json.dumps({
        "profile": f"headline stages ({engine})", "k_values": list(ks),
        "h": args.h, "stream_h_block": args.stream,
        "nvidia_smi": smi, "device": torch.cuda.get_device_name(0),
        "run_seconds": plain["run_seconds"],
        "resamples_per_second": plain["resamples_per_second"],
        "launches": plain["kernel_launches"],
        "timed_run_seconds": timed_wall,
        "stage_seconds": stages,
        "lloyd_lanes": lloyd_lanes,
    }, default=float), flush=True)

    _profile_one_k(km, dataclasses.replace(config, k_values=(args.profile_k,)),
                   x, run, engine, smi, args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
