"""One run of one cell: set-up, the measured window, the traced sub-window,
the check against the plain reference, and the result line.

A cell (an entry of ``workloads`` in ``BENCHMARK.json``) names a
configuration (``configs/<config>.json``: the deployment, its data and the
fit's keyword arguments that define it) and a traffic mix
(``traffic/<traffic>.json``: the keyword arguments of the engine this
traffic drives, the warm-up size); ``workloads/<cell>.json`` holds what
the check of its answers compares and the limits.  Per-layer metrics are
read by ``metrics/<name>.py`` from the traced sweep's record: the trace's
summary, the program's own ranges (``cc.*``) and counters (its
``metrics_``), and the spans of the kernel launchers that
``bounds/<span>.py`` name.  Adding a cell, a configuration, a metric, a
program range, a counter or a kernel's bound is adding a file.

A configuration names its data generator, its clusterer and, where the
check reads what the clusterer returns, the program's function to capture
it from; each is looked up by name, so a configuration with another
clusterer is these files and no edit:

- ``configs/<config>.json``: ``data.generator`` (``make_blobs``, else
  ``reference/data/<generator>.py``, whose ``make(data, seed)`` returns
  the rows), ``clusterer.name`` (``KMeans`` runs the program's default
  clusterer with ``clusterer_options`` from ``n_init``, ``max_iter`` and
  ``tol``; any other name is the class of that name in the program's
  ``models`` package, built from ``clusterer.options`` and passed as
  ``clusterer=``) and optionally ``clusterer.capture`` (module, owner,
  attribute; default :data:`portbench.check.CLUSTERER`);
- ``reference/clusterers/<name>.py`` for a clusterer other than KMeans:
  ``cluster(x, indices, key_cluster, k, k_max, clusterer, group,
  precision)`` returns each lane's labels and its parameters (or None),
  and an optional ``numbers(captured, fitted, ks)`` returns further
  numbers for the check, each compared where the cell's limits name it;
- ``traffic/<traffic>.json``, ``workloads/<cell>.json`` (limits without
  ``centroid_gap`` where the clusterer has no centres), an entry in
  ``BENCHMARK.json``, and ``metrics/<name>.py`` for any new metric.

A traffic file may say ``processes``, ``backend`` and ``mesh``: the cell
then runs as that many processes with one device each on a
(``k_shards``, rest, ``row_shards``) mesh (:mod:`portbench.ranks`).

The window is a closed loop of one analyst: whole sweeps through
``ConsensusClustering.fit``, back to back, each with a fresh
``random_state`` drawn from the run's seed and the sweep's index, on one
data set made from the seed.  No sweep starts once the window's seconds
have passed; the window ends when the last sweep that started has
returned with its curves on the host.
"""

from __future__ import annotations

import contextlib
import gc
import importlib.util
import json
import os
import subprocess
import sys
import time
from typing import Any, Dict, List, Optional

import numpy as np

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
#: Build and kernel caches of the program, at fixed paths in the checkout.
CACHE_DIRS = {
    "CCTPU_COMPILATION_CACHE": os.path.join(BENCH_DIR, ".cache", "kernels"),
    "TRITON_CACHE_DIR": os.path.join(BENCH_DIR, ".cache", "triton"),
    "TORCH_EXTENSIONS_DIR": os.path.join(BENCH_DIR, ".cache",
                                         "torch_extensions"),
    "CUDA_CACHE_PATH": os.path.join(BENCH_DIR, ".cache", "cuda"),
}
#: Top-level modules no run may load (compared whole: the port's name
#: begins with the JAX package's).
FORBIDDEN = ("jax", "jaxlib", "flax", "consensus_clustering_tpu")
MASK64 = (1 << 64) - 1


class CellError(RuntimeError):
    """A cell's files are missing or disagree with ``BENCHMARK.json``."""


def set_environment() -> None:
    """The caches of the program inside the checkout, and no JAX for any
    library that would load it by itself.  Before torch is imported."""
    for name, path in CACHE_DIRS.items():
        os.environ[name] = path
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    os.environ.setdefault("OMP_NUM_THREADS", "1")


def _load_json(*parts: str) -> Dict[str, Any]:
    path = os.path.join(*parts)
    if not os.path.isfile(path):
        raise CellError(f"missing {os.path.relpath(path, ROOT)}")
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, root: str = ROOT) -> Dict[str, Any]:
    """The cell ``name`` resolved from ``BENCHMARK.json`` and the files of
    its configuration, traffic and check."""
    spec = _load_json(root, "BENCHMARK.json")
    bench = os.path.join(root, os.path.basename(BENCH_DIR))
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise CellError(f"no workload {name!r} in BENCHMARK.json "
                        f"(have {sorted(cells)})")
    entry = cells[name]
    config = _load_json(bench, "configs", f"{entry['config']}.json")
    traffic = _load_json(bench, "traffic", f"{entry['traffic']}.json")
    workload = _load_json(bench, "workloads", f"{name}.json")
    for key in ("config", "traffic", "chips"):
        if workload.get(key) != entry[key]:
            raise CellError(f"workloads/{name}.json has {key}="
                            f"{workload.get(key)!r}, BENCHMARK.json "
                            f"{entry[key]!r}")

    def applies(metric):
        return name in metric.get("workloads", [name])

    processes = int(traffic.get("processes", 1))
    if processes > 1 and not {"backend", "mesh"} <= set(traffic):
        raise CellError(f"traffic {entry['traffic']} spans {processes} "
                        f"processes but names no backend and mesh")

    end_to_end = [m for m in spec["end_to_end"] if applies(m)]
    reported = {m["name"] for m in end_to_end}
    per_layer = [m for m in spec["per_layer"]
                 if applies(m) and m["moves"] in reported]
    return {"name": name, "chips": entry["chips"], "config": config,
            "traffic": traffic, "workload": workload,
            "processes": processes,
            "end_to_end": end_to_end, "per_layer": per_layer,
            "bench_dir": bench, "root": root,
            "metrics_dir": os.path.join(bench, "metrics"),
            "bounds_dir": os.path.join(bench, "bounds")}


def _module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def reader(metrics_dir: str, name: str):
    """The ``read(record)`` function of ``metrics/<name>.py``."""
    path = os.path.join(metrics_dir, f"{name}.py")
    if not os.path.isfile(path):
        raise CellError(f"no reader metrics/{name}.py")
    return _module(path, f"portbench.metrics.{name}").read


def reference_module(bench_dir: str, kind: str, name: str):
    """``reference/<kind>/<name>.py`` of the benchmark directory: a data
    generator (``data``) or a lane clusterer (``clusterers``)."""
    path = os.path.join(bench_dir, "reference", kind, f"{name}.py")
    if not os.path.isfile(path):
        raise CellError(f"no reference/{kind}/{name}.py")
    return _module(path, f"portbench_reference_{kind}_{name}")


def device_clusterer(name: str, options: Dict[str, Any]):
    """The program's device clusterer of class ``name`` (any module of
    its ``models`` package), built from ``options``."""
    import pkgutil

    from consensus_clustering_tpu_torch import models

    for info in pkgutil.iter_modules(models.__path__):
        module = importlib.import_module(f"{models.__name__}.{info.name}")
        found = getattr(module, name, None)
        if isinstance(found, type):
            return found(**options)
    raise CellError(f"the program's models have no clusterer {name!r}")


def fit_kwargs(cell: Dict[str, Any]) -> Dict[str, Any]:
    """The constructor's keyword arguments: the configuration's, then the
    traffic's (which may not repeat one)."""
    base = dict(cell["config"]["fit"])
    extra = cell["traffic"].get("fit", {})
    clash = set(base) & set(extra)
    if clash:
        raise CellError(f"traffic {cell['traffic']['name']} repeats "
                        f"{sorted(clash)} of its configuration")
    kwargs = {**base, **extra}
    k_lo, k_hi = kwargs.pop("K_range")
    kwargs["K_range"] = list(range(int(k_lo), int(k_hi) + 1))
    clusterer = cell["config"]["clusterer"]
    if clusterer["name"] == "KMeans":
        # The program's own default: an explicit KMeans() is a pin that
        # the program treats apart (its calibrated max_iter).
        kwargs["clusterer_options"] = {
            key: clusterer[key] for key in ("n_init", "max_iter", "tol")}
    else:
        kwargs["clusterer"] = device_clusterer(clusterer["name"],
                                               clusterer.get("options", {}))
    kwargs["plot_cdf"] = False
    kwargs["progress"] = False
    return kwargs


def make_data(config: Dict[str, Any], seed: int,
              bench_dir: str = BENCH_DIR) -> np.ndarray:
    """The configuration's rows from the seed, float32: ``make_blobs``,
    or ``reference/data/<generator>.py``'s ``make(data, seed)``."""
    data = config["data"]
    if data["generator"] != "make_blobs":
        module = reference_module(bench_dir, "data", data["generator"])
        return np.asarray(module.make(data, seed)).astype(np.float32)
    from portbench.reference.blobs import make_blobs

    x, _ = make_blobs(int(data["n_samples"]), int(data["n_features"]),
                      int(data["centers"]), float(data["cluster_std"]),
                      random_state=seed % 2**32)
    return x.astype(np.float32)


def derived_seed(seed: int, *stream: int) -> int:
    """A 31-bit seed of its own for each stream of one run."""
    state = np.random.SeedSequence([seed & MASK64, *stream])
    return int(state.generate_state(1)[0]) & 0x7FFFFFFF


def sweep_result(cc, random_state: int, fit_s: float) -> Dict[str, Any]:
    """What the check and the metrics read of one finished sweep."""
    m = cc.metrics_
    ks = sorted(cc.cdf_at_K_data)
    h_eff = int(m.get("streaming", {}).get("h_effective", cc.n_iterations))
    out = {
        "random_state": random_state, "fit_s": fit_s,
        "run_seconds": float(m["run_seconds"]),
        "resamples": h_eff * len(ks), "h_effective": h_eff,
        "mode": m.get("mode", "exact"), "ks": ks,
        "cdf": {k: np.asarray(cc.cdf_at_K_data[k]["cdf"]) for k in ks},
        "pac": {k: float(cc.cdf_at_K_data[k]["pac_area"]) for k in ks},
        "best_k": int(cc.best_k_),
    }
    refined = m.get("exact_best_k")
    if refined is not None:
        out["refined_k"] = int(refined["k"])
        out["pac_estimate_at_refined_k"] = float(refined["pac_area_estimate"])
    return out


class PeakWatch:
    """The allocator's high-water over a window on one card, across the
    program's own resets of it (each sweep resets it at its start)."""

    def __init__(self, torch, device):
        self.torch, self.device, self.peak = torch, device, 0

    def __enter__(self):
        cuda = self.torch.cuda
        self._reset = cuda.reset_peak_memory_stats
        cuda.synchronize(self.device)
        self._reset(self.device)

        def reset(device=None):
            self.peak = max(self.peak, cuda.max_memory_allocated(device))
            self._reset(device)

        cuda.reset_peak_memory_stats = reset
        return self

    def __exit__(self, *exc):
        cuda = self.torch.cuda
        cuda.reset_peak_memory_stats = self._reset
        cuda.synchronize(self.device)
        self.peak = max(self.peak, cuda.max_memory_allocated(self.device))
        return False


def power_limit() -> Optional[str]:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.SubprocessError):
        return None
    lines = out.stdout.strip().splitlines()
    return lines[0] if lines else None


def forbidden_modules() -> List[str]:
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def run_cell(cell: Dict[str, Any], seed: int, seconds: float, trace: bool,
             device: str = "cuda", t_start: Optional[float] = None,
             precision: str = "float32", warm_up: bool = True,
             group=None) -> Optional[Dict[str, Any]]:
    """One run; returns the result line's object (``check`` last).

    ``device`` "cpu" runs the program's plain versions (the tests' drive
    of the harness); ``precision`` "tf32" puts the reference computed in
    TF32 in the program's place (:mod:`portbench.control`), which the
    check must refuse.  ``warm_up`` False skips the set-up fit, for runs
    in a process whose first run made it (:mod:`portbench.readings`).
    ``group`` (:class:`portbench.ranks.Group`) is this process's place in
    a cell that spans processes: every rank runs the same sweeps on the
    group's mesh in lockstep, and rank 0 alone returns the result (the
    others None).
    """
    import torch

    from consensus_clustering_tpu_torch import ConsensusClustering
    from consensus_clustering_tpu_torch.utils.platform import (
        enable_compilation_cache,
    )
    from portbench import check
    from portbench import trace as tracing

    if precision not in ("float32", "tf32"):
        raise ValueError(f"precision must be float32 or tf32, got "
                         f"{precision!r}")
    t_start = time.perf_counter() if t_start is None else t_start
    on_cuda = device == "cuda"
    if on_cuda:
        enable_compilation_cache()
    kwargs = fit_kwargs(cell)
    # One device, or the group's mesh (whose primary is this process's).
    where = {"device": device} if group is None else {"mesh": group.mesh}
    x = make_data(cell["config"], seed, cell["bench_dir"])
    # Set-up: one fit at the cell's shapes, with its H, at its least and
    # largest K (every K has the same shapes: the centre slots are the
    # largest K's), so the kernels are built or loaded and the allocator
    # and libraries are warm.
    if precision == "float32" and warm_up:
        ks = kwargs["K_range"]
        ConsensusClustering(**dict(kwargs, K_range=[ks[0], ks[-1]]),
                            random_state=derived_seed(seed, 1),
                            **where).fit(x)
    if on_cuda:
        torch.cuda.synchronize()
    gc.collect()
    if group is not None:
        group.gather(None)  # every rank set up
    setup_s = time.perf_counter() - t_start

    peak = PeakWatch(torch, torch.device(device)) if on_cuda else None
    target = check.checked_index(seed, int(cell["workload"]["check"]
                                           ["within"]))
    host0 = host_reading()
    w0 = time.perf_counter()
    if group is not None:
        group.opened()
    with peak if peak is not None else contextlib.nullcontext():
        window = _window(cell, kwargs, x, seed, seconds, trace, device,
                         precision, target, where, group)
    window_s = time.perf_counter() - w0
    host = host_change(host0, host_reading(), window_s)
    sweeps, failed = window["sweeps"], window["failed"]
    peak_bytes = peak.peak if peak is not None else 0
    gc.collect()
    if on_cuda:
        torch.cuda.empty_cache()
    index = min(target, len(sweeps) - 1)
    centroids, ranks = window["centroids"], None
    if group is not None:
        centroids, ranks = _gather_ranks(group, window, index, peak_bytes,
                                         precision)
        if group.rank != 0:
            return None

    metrics: Dict[str, Dict[str, Any]] = {}
    notes = []
    if not trace:
        values = {
            "resamples_per_s": sum(s["resamples"] for s in sweeps) / window_s,
            "peak_mem_gb": (peak_bytes if ranks is None
                            else max(ranks["peaks"])) / 1e9,
            "setup_s": setup_s,
        }
        for m in cell["end_to_end"]:
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    else:
        record = {"sweeps": sweeps, "trace": window["summary"] or {},
                  "spans": window["spans"] or {},
                  "program": window["program"] or {"ranges": {},
                                                   "metrics": {}}}
        for m in cell["per_layer"]:
            value = reader(cell["metrics_dir"], m["name"])(record)
            if value is None:
                notes.append(f"metric {m['name']}: nothing to read "
                             f"({_why_missing(record)})")
            else:
                metrics[m["name"]] = {"value": float(value),
                                      "unit": m["unit"]}
    for note in notes:
        print(note, file=sys.stderr)
    print(f"portbench: setup {setup_s:.3f} s, window {window_s:.3f} s, "
          f"{len(sweeps)} sweep(s)", file=sys.stderr)
    t_check = time.perf_counter()
    if sweeps:
        extra = {} if ranks is None else {"rank_gap": ranks["gap"]}
        verdict = check.check_sweep(cell, x, sweeps[index], centroids,
                                    device, extra)
    else:
        verdict = {"correct": False, "numbers": {}}
    window["centroids"] = centroids = {}
    check_s = time.perf_counter() - t_check
    result: Dict[str, Any] = {
        "correct": failed == 0 and bool(sweeps) and verdict["correct"],
        "attempted": len(sweeps) + failed,
        "failed": failed,
        "metrics": metrics,
        "device": {
            "platform": "gpu" if on_cuda else "cpu",
            "kind": torch.cuda.get_device_name(0) if on_cuda else "cpu",
            "count": int(cell["chips"]),
            "memory_peak_bytes": int(peak_bytes if ranks is None
                                     else max(ranks["peaks"])),
        },
    }
    if ranks is not None:
        result["device"]["memory_peak_bytes_by_card"] = [
            int(p) for p in ranks["peaks"]]
    if on_cuda:
        result["device"]["power"] = power_limit()
    summary = window["summary"]
    if trace and summary is not None:
        # Rank 0's trace; the busy seconds are the mean over the cards.
        result["device"]["busy_s"] = (summary["busy_s"] if ranks is None
                                      else float(np.mean(ranks["busy_s"])))
        result["device"]["window_s"] = summary["window_s"]
        # Idle gaps by the program range the host was in.
        ranges = (window["program"] or {}).get("ranges") or {}
        result["breakdown"] = {
            "device_ops": summary["device_ops"],
            "idle_gaps": tracing.longest({name: e["idle_s"]
                                          for name, e in ranges.items()
                                          if e["idle_s"]})}
    result["notes"] = notes
    result["seconds"] = {"setup": setup_s, "window": window_s,
                         "check": check_s,
                         "sweeps": [s["fit_s"] for s in sweeps]}
    if trace and len(sweeps) > 1:
        # The traced sweep's wall against the untraced ones' median: how
        # far the profiler slowed the window the traced metrics describe.
        result["seconds"]["trace_inflation"] = sweeps[0]["fit_s"] / float(
            np.median([s["fit_s"] for s in sweeps[1:]]))
    result["host"] = host
    result["centroid_gap_by_k"] = verdict.get("centroid_gap_by_k", {})
    result["check"] = verdict["numbers"]
    return result


def _gather_ranks(group, window: Dict[str, Any], index: int,
                  peak_bytes: int, precision: str):
    """After the window, every rank's share of what rank 0 reports: the
    checked sweep's captured outputs joined in resample order (each rank
    clusters its own lanes; a rank's lanes follow the lower ranks' on a
    mesh without 'k' shards, the only one a cell may ask for), the largest
    gap between any rank's curves and choice and rank 0's (``gap``), each
    card's peak and traced busy seconds.  Rank 0 gets them; the others
    None."""
    sweep = window["sweeps"][index] if window["sweeps"] else None
    mine = {
        "peak": int(peak_bytes),
        "busy_s": (window["summary"] or {}).get("busy_s"),
        "answer": None if sweep is None else {
            "cdf": sweep["cdf"], "pac": sweep["pac"],
            "best_k": sweep["best_k"]},
        # The control computes every lane in each rank: rank 0's are all.
        "captured": {k: [p.detach().cpu() for p in parts]
                     for k, parts in window["centroids"].items()}
        if precision == "float32" or group.rank == 0 else {},
    }
    everyone = group.gather(mine)
    if group.rank != 0:
        return None, None
    captured: Dict[int, list] = {}
    for other in everyone:
        for k, parts in other["captured"].items():
            captured.setdefault(k, []).extend(parts)
    gap = 0.0
    ref = everyone[0]["answer"]
    for other in everyone[1:]:
        got = other["answer"]
        if ref is None or got is None:
            gap = float("inf")
            continue
        for k in ref["cdf"]:
            gap = max(gap, float(np.abs(np.asarray(got["cdf"][k])
                                        - np.asarray(ref["cdf"][k])).max()),
                      abs(got["pac"][k] - ref["pac"][k]))
        gap = max(gap, float(abs(got["best_k"] - ref["best_k"])))
    busy = [o["busy_s"] for o in everyone if o["busy_s"] is not None]
    return captured, {"gap": gap, "peaks": [o["peak"] for o in everyone],
                      "busy_s": busy}


def _window(cell, kwargs, x, seed: int, seconds: float, trace: bool,
            device: str, precision: str, target: int, where: Dict[str, Any],
            group=None) -> Dict[str, Any]:
    """The measured window: whole sweeps until ``seconds`` have passed,
    the first one profiled in a traced run; a sweep that raises is a
    failed request and ends the window (across processes it ends the
    process: the other ranks wait in a collective, and the launcher ends
    them).  Across processes rank 0 decides whether each sweep starts.
    What the clusterer returned in sweep ``target`` (or in the last
    sweep, where fewer ran) is kept for the check."""
    import importlib

    from consensus_clustering_tpu_torch import ConsensusClustering
    from portbench import check, control

    out: Dict[str, Any] = {"sweeps": [], "failed": 0, "summary": None,
                           "spans": None, "program": None, "centroids": {}}
    sweeps = out["sweeps"]
    clusterer = cell["config"]["clusterer"]
    module, owner, attr = clusterer.get("capture", check.CLUSTERER)
    owner = getattr(importlib.import_module(module), owner)
    capture = check.Capture()
    fit_fn = getattr(owner, attr)
    setattr(owner, attr, capture.wrap(fit_fn))
    try:
        w0 = time.perf_counter()
        while True:
            go = not sweeps or time.perf_counter() - w0 < seconds
            if group is not None:
                go = group.decide(go)
            if not go:
                break
            rs = derived_seed(seed, 2, len(sweeps))
            capture.on = len(sweeps) <= target
            if capture.on:
                capture.by_k = {}
            try:
                if precision != "float32":
                    record, centroids = control.control_sweep(cell, x, rs,
                                                              device)
                    if capture.on:
                        capture.by_k = centroids
                    sweeps.append(record)
                    continue
                cc = ConsensusClustering(**kwargs, random_state=rs, **where)
                if trace and not sweeps:
                    (fit_s, out["summary"], out["spans"],
                     out["program"]) = _profiled_fit(cc, x, cell, device)
                else:
                    t0 = time.perf_counter()
                    cc.fit(x)
                    fit_s = time.perf_counter() - t0
            except Exception as e:  # noqa: BLE001 -- a failed request
                print(f"sweep {len(sweeps)} failed: {type(e).__name__}: "
                      f"{e}", file=sys.stderr)
                if group is not None:
                    raise
                out["failed"] += 1
                break
            sweeps.append(sweep_result(cc, rs, fit_s))
            del cc
    finally:
        setattr(owner, attr, fit_fn)
    out["centroids"] = capture.by_k
    return out


def host_reading() -> Dict[str, float]:
    """The process's CPU seconds and involuntary switches, and the
    machine's CPU ticks, busy and stolen, as ``/proc/stat`` has them."""
    import resource

    use = resource.getrusage(resource.RUSAGE_SELF)
    out = {"cpu_s": use.ru_utime + use.ru_stime,
           "involuntary_switches": float(use.ru_nivcsw)}
    try:
        with open("/proc/stat") as f:
            fields = [float(v) for v in f.readline().split()[1:]]
        out["ticks"] = sum(fields)
        out["idle_ticks"] = fields[3] + (fields[4] if len(fields) > 4 else 0)
        out["steal_ticks"] = fields[7] if len(fields) > 7 else 0.0
    except (OSError, ValueError, IndexError):
        pass
    return out


def host_change(before: Dict[str, float], after: Dict[str, float],
                window_s: float) -> Dict[str, float]:
    """What the host did over the window: the process's CPU seconds per
    second of window, its involuntary switches, and the machine's busy
    and stolen shares of its CPU ticks."""
    out = {"process_cpu_share": (after["cpu_s"] - before["cpu_s"])
           / max(window_s, 1e-9),
           "involuntary_switches": after["involuntary_switches"]
           - before["involuntary_switches"]}
    if "ticks" in before and "ticks" in after:
        ticks = max(after["ticks"] - before["ticks"], 1.0)
        out["machine_busy_share"] = 1.0 - (
            after["idle_ticks"] - before["idle_ticks"]) / ticks
        out["machine_steal_share"] = (
            after["steal_ticks"] - before["steal_ticks"]) / ticks
    return out


def _why_missing(record: Dict[str, Any]) -> str:
    gone = record["spans"].get("_missing") or {}
    if gone:
        return "the program no longer has " + ", ".join(sorted(
            gone.values()))
    return "the traced window holds none of what it reads"


def _plain(value):
    """A value of the program's ``metrics_`` as JSON takes it."""
    if hasattr(value, "tolist"):
        return value.tolist()
    return str(value)


def _profiled_fit(cc, x, cell: Dict[str, Any], device: str):
    """One sweep under the profiler, with the program's ranges recorded
    and the launchers of ``bounds/`` wrapped: the fit's seconds (the
    profiler's own teardown left out), the trace's summary, the spans'
    record, and the program's record (its ranges,
    :func:`portbench.trace.summarize_program`, and the sweep's whole
    ``metrics_`` as JSON).  The profiler records user ranges and, on the
    card, the launches and device operations, but none of PyTorch's own
    operators (:func:`portbench.trace.profiling`)."""
    import torch

    from portbench import spans
    from portbench import trace as tracing

    from consensus_clustering_tpu_torch.obs.tracing import recording_ranges

    watched = spans.Spans(cell["config"], cell["bounds_dir"])
    with watched.installed():
        with tracing.profiling(device == "cuda") as prof:
            with recording_ranges():
                with torch.profiler.record_function(tracing.WINDOW):
                    t0 = time.perf_counter()
                    cc.fit(x)
                    if device == "cuda":
                        torch.cuda.synchronize()
                    fit_s = time.perf_counter() - t0
    t1 = time.perf_counter()
    events = prof.events()
    summary = tracing.summarize(events)
    program = {"ranges": tracing.summarize_program(events) or {},
               "metrics": json.loads(json.dumps(cc.metrics_,
                                                default=_plain))}
    print(f"portbench: profiler stop {t1 - t0 - fit_s:.3f} s, trace read "
          f"{time.perf_counter() - t1:.3f} s", file=sys.stderr)
    record = watched.record()
    record["_missing"] = dict(watched.missing)
    return fit_s, summary, record, program
