# Ported from consensus_clustering_tpu/autotune/probes.py.
"""Parity-gated probe registry: the measurements behind every knob.

Each probe times one performance knob's candidate settings at a shape
bucket and asserts PAC parity against the untouched baseline BEFORE any
result may become a calibration record — the correctness bar is the
paper's own: Monti et al. (2003) consensus matrices and the
Şenbabaoğlu et al. (2014) PAC criterion must not drift when a perf knob
is pinned.  Two gate modes:

- ``bit-identical`` — the PAC vector must match at the probe's
  5-decimal rounding (the ``decide_maxiter.py`` rule).  This is the
  gate for ``max_iter`` (empirically identical: late Lloyd iterations
  move centroids within tol without changing labels) and for
  ``cluster_batch``/``split_init``/``stream_h_block`` (identical BY
  CONSTRUCTION — a divergence there is a code regression, which is why
  ``autotune run`` exits non-zero on any bit-identical gate failure).
- ``tolerance`` — ``adaptive_tol`` trades resamples for bounded PAC
  drift; a candidate tolerance is eligible only when its measured drift
  stays within the tolerance it states, and the record keeps the drift.

Probe shapes come in three scales: ``smoke`` (seconds), ``small``
(CPU minutes), ``full`` (the bench shapes, for a run on the card: one
``autotune run --shapes full``).  A ``--budget`` seconds cap is
honoured between measurements: whatever does not fit is reported
``budget-skipped``, never half-measured.

Every probe runs on the context's ``device`` (``cuda`` unless the
caller asks for ``cpu``), and its records carry that device's
environment.  Where the reference's sweeps take ``repeats`` and time
the fastest execution of one compiled program, the port's engines run
eagerly: a probe here repeats the whole fit ``repeats`` times and keeps
the fastest.
"""

from __future__ import annotations

import dataclasses
import sys
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from consensus_clustering_tpu_torch.autotune.store import (
    CalibrationStore,
    make_record,
    shape_bucket,
)

DEFAULT_SEED = 23  # the headline's seed, which every tool shares

_PROBES: Dict[str, "Probe"] = {}


@dataclasses.dataclass
class Budget:
    """Wall-clock cap for a probe run; ``None`` = unbounded."""

    seconds: Optional[float] = None
    _t0: float = dataclasses.field(default_factory=time.perf_counter)

    def elapsed(self) -> float:
        return time.perf_counter() - self._t0

    def exhausted(self) -> bool:
        return self.seconds is not None and self.elapsed() >= self.seconds


@dataclasses.dataclass
class ProbeContext:
    store: CalibrationStore
    budget: Budget
    shapes: str = "small"  # smoke | small | full
    seed: int = DEFAULT_SEED
    repeats: int = 1  # >1 on the card filters a shared host's noise
    device: str = "cuda"

    def log(self, msg: str) -> None:
        print(f"autotune: {msg}", file=sys.stderr, flush=True)


@dataclasses.dataclass(frozen=True)
class Probe:
    name: str
    knob: str
    description: str
    fn: Callable[[ProbeContext], Dict[str, Any]]


def register(name: str, knob: str, description: str):
    def deco(fn):
        _PROBES[name] = Probe(name, knob, description, fn)
        return fn

    return deco


def list_probes() -> List[Probe]:
    return list(_PROBES.values())


def get_probe(name: str) -> Probe:
    if name not in _PROBES:
        raise KeyError(
            f"unknown probe {name!r} (available: {sorted(_PROBES)})"
        )
    return _PROBES[name]


# -- shared measurement helpers ------------------------------------------


def pac_parity(
    pac_candidate: Sequence[float],
    pac_baseline: Sequence[float],
    tolerance: float = 0.0,
) -> Dict[str, Any]:
    """The gate: PAC vectors compared at 5-decimal rounding.

    ``tolerance=0.0`` is the bit-identical mode; otherwise the stated
    tolerance the record must carry.
    """
    a = [round(float(v), 5) for v in pac_candidate]
    b = [round(float(v), 5) for v in pac_baseline]
    if len(a) != len(b):
        return {
            "gate": "bit-identical" if tolerance == 0.0 else "tolerance",
            "tolerance": tolerance,
            "max_pac_delta": None,
            "passed": False,
            "reason": f"PAC length mismatch ({len(a)} vs {len(b)})",
        }
    max_delta = max(abs(x - y) for x, y in zip(a, b)) if a else 0.0
    max_delta = round(max_delta, 5)
    return {
        "gate": "bit-identical" if tolerance == 0.0 else "tolerance",
        "tolerance": tolerance,
        "max_pac_delta": max_delta,
        "k_values_compared": len(a),
        "passed": (max_delta == 0.0 if tolerance == 0.0
                   else max_delta <= tolerance),
    }


def _blobs(n: int, d: int, std: float = 3.0, seed: int = 0):
    import numpy as np

    from consensus_clustering_tpu_torch.data import make_blobs

    x, _ = make_blobs(
        n_samples=n, n_features=d, centers=8, cluster_std=std,
        random_state=seed,
    )
    return x.astype(np.float32)


def _fastest(run: Callable[[], Dict[str, Any]], repeats: int):
    """(PAC list, the fastest rate, that run's ``out``) of ``repeats``
    runs of the same fit (the same PAC every time: the fit is a pure
    function of its inputs)."""
    best = None
    for _ in range(repeats):
        out = run()
        rate = float(out["timing"]["resamples_per_second"])
        if best is None or rate > best[1]:
            best = (out, rate)
    out, rate = best
    return [float(p) for p in out["pac_area"]], rate, out


def _run_monolithic(clusterer, config, x, ctx: ProbeContext):
    from consensus_clustering_tpu_torch.parallel.sweep import run_sweep

    return _fastest(lambda: run_sweep(clusterer, config, x, ctx.seed,
                                      device=ctx.device), ctx.repeats)


def _run_streamed(clusterer, config, x, ctx: ProbeContext):
    from consensus_clustering_tpu_torch.parallel.streaming import (
        run_streaming_sweep,
    )

    return _fastest(lambda: run_streaming_sweep(
        clusterer, config, x, ctx.seed, device=ctx.device), ctx.repeats)


def _summary(probe: str, knob: str) -> Dict[str, Any]:
    return {
        "probe": probe,
        "knob": knob,
        "status": "complete",
        "records": [],
        "measurements": [],
        "gate_failures": [],
        "skipped": [],
    }


def _out_of_budget(ctx: ProbeContext, summary: Dict[str, Any],
                   what: str) -> bool:
    if ctx.budget.exhausted():
        summary["skipped"].append(what)
        summary["status"] = "budget-skipped"
        ctx.log(f"budget exhausted ({ctx.budget.elapsed():.0f}s) — "
                f"skipping {what}")
        return True
    return False


# -- probes ---------------------------------------------------------------

_MAXITER_SHAPES = {
    # The 19-value K range (2..20): a cap is gated on the FULL PAC
    # vector, and the small shape runs the same comparison at CPU scale
    # (8 centers, std 3.0).
    "smoke": dict(n=300, d=10, h=24, k_hi=6, candidates=(25,)),
    "small": dict(n=1500, d=20, h=60, k_hi=20, candidates=(25,)),
    # blobs10k, the reference's bench shape (bench.py FULL_SHAPES), with
    # its cluster_batch=8.
    "full": dict(n=10000, d=50, h=1000, k_hi=20, candidates=(25,),
                 chunk=8, cluster_batch=8),
}


@register(
    "max_iter", "max_iter",
    "Lloyd max_iter cap vs the default 100: full-PAC-vector parity "
    "(bit-identical) gates the measured speedup",
)
def probe_max_iter(ctx: ProbeContext) -> Dict[str, Any]:
    from consensus_clustering_tpu_torch.config import SweepConfig
    from consensus_clustering_tpu_torch.models.kmeans import KMeans

    s = _MAXITER_SHAPES[ctx.shapes]
    summary = _summary("max_iter", "max_iter")
    if _out_of_budget(ctx, summary, "max_iter baseline"):
        return summary
    x = _blobs(s["n"], s["d"])
    k_values = tuple(range(2, s["k_hi"] + 1))
    config = SweepConfig(
        n_samples=s["n"], n_features=s["d"], k_values=k_values,
        n_iterations=s["h"], store_matrices=False,
        chunk_size=s.get("chunk", 8),
        cluster_batch=s.get("cluster_batch"),
    )
    bucket = shape_bucket(s["n"], s["d"], s["h"], k_values)
    baseline = KMeans(n_init=3)  # max_iter=100, the measured default
    ctx.log(f"max_iter: baseline max_iter={baseline.max_iter} @ {bucket}")
    pac_base, rate_base, _ = _run_monolithic(
        baseline, config, x, ctx
    )
    summary["measurements"].append(
        {"max_iter": baseline.max_iter, "rate": round(rate_base, 2)}
    )
    best = None  # (cap, rate, parity) among winning candidates
    checked = None  # (cap, rate, parity) of any parity-passing candidate
    for cap in s["candidates"]:
        if _out_of_budget(ctx, summary, f"max_iter={cap}"):
            return summary
        ctx.log(f"max_iter: candidate max_iter={cap}")
        pac, rate, _ = _run_monolithic(
            dataclasses.replace(baseline, max_iter=cap),
            config, x, ctx,
        )
        parity = pac_parity(pac, pac_base)
        speedup = rate / max(rate_base, 1e-9)
        summary["measurements"].append(
            {"max_iter": cap, "rate": round(rate, 2),
             "speedup": round(speedup, 3), "parity": parity}
        )
        if not parity["passed"]:
            # The empirical property the recommendation rests on broke:
            # surface it as a gate failure (``autotune run`` exits 1).
            summary["gate_failures"].append(
                {"candidate": cap, "parity": parity}
            )
            summary["status"] = "parity-failed"
            continue
        checked = (cap, rate, parity)
        if speedup > 1.0 and (best is None or rate > best[1]):
            best = (cap, rate, parity)
    # Record the verdict either way (the split_init rule): a winning
    # cap pins it; identical-but-not-faster commits "keep the default"
    # WITH the full-PAC-vector parity evidence, so the gate comparison
    # is a stored artifact, not a rerun.
    decided = best or checked
    if decided is not None:
        evidence = {
            "k_values": list(k_values),
            "pac_baseline": [round(p, 5) for p in pac_base],
            "candidates": [
                {k: v for k, v in m.items() if k != "parity"}
                for m in summary["measurements"]
            ],
        }
        if best is not None:
            cap, rate, parity = best
            record = make_record(
                "max_iter", bucket, int(cap),
                parity=parity, rate=rate,
                baseline_value=int(baseline.max_iter),
                baseline_rate=rate_base, probe="max_iter",
                env=ctx.store.env, evidence=evidence,
            )
        else:
            # Keep-the-default verdict: the recommended value is the
            # BASELINE, so the record's rate is the baseline's (the
            # losing candidates' numbers live in the evidence) — a
            # disclosure must never describe a setting that was not
            # recommended.
            _, _, parity = checked
            record = make_record(
                "max_iter", bucket, int(baseline.max_iter),
                parity=parity, rate=rate_base, probe="max_iter",
                env=ctx.store.env, evidence=evidence,
            )
        summary["records"].append(ctx.store.save(record))
    return summary


_CLUSTER_BATCH_SHAPES = {
    "smoke": dict(n=240, d=8, h=32, k_hi=5, candidates=(8,)),
    "small": dict(n=800, d=16, h=64, k_hi=10, candidates=(8, 16, 32)),
    # the headline bench shape.
    "full": dict(n=5000, d=50, h=500, k_hi=20, candidates=(8, 16, 32),
                 chunk=4),
}


@register(
    "cluster_batch", "cluster_batch",
    "Clustering sub-batch size vs one batch (bit-identical by "
    "construction), plus per-K sub-range records when budget allows",
)
def probe_cluster_batch(ctx: ProbeContext) -> Dict[str, Any]:
    from consensus_clustering_tpu_torch.config import SweepConfig
    from consensus_clustering_tpu_torch.models.kmeans import KMeans

    s = _CLUSTER_BATCH_SHAPES[ctx.shapes]
    summary = _summary("cluster_batch", "cluster_batch")
    if _out_of_budget(ctx, summary, "cluster_batch baseline"):
        return summary
    x = _blobs(s["n"], s["d"])
    km = KMeans(n_init=3)

    def _measure(k_values, batch):
        config = SweepConfig(
            n_samples=s["n"], n_features=s["d"], k_values=k_values,
            n_iterations=s["h"], store_matrices=False,
            chunk_size=s.get("chunk", 8), cluster_batch=batch,
        )
        return _run_monolithic(km, config, x, ctx)

    def _sweep_candidates(k_values, label):
        """(best_batch, best_rate, rate_base, pac_base) over candidates
        at one K range; gate failures recorded on the way."""
        bucket = shape_bucket(s["n"], s["d"], s["h"], k_values)
        ctx.log(f"cluster_batch: baseline (one batch) @ {bucket}")
        pac_base, rate_base, _ = _measure(k_values, None)
        summary["measurements"].append(
            {"range": label, "cluster_batch": None,
             "rate": round(rate_base, 2)}
        )
        best = (None, rate_base, None)  # (batch, rate, parity)
        for batch in s["candidates"]:
            if _out_of_budget(ctx, summary,
                              f"cluster_batch={batch} [{label}]"):
                return None
            ctx.log(f"cluster_batch: candidate {batch} [{label}]")
            pac, rate, _ = _measure(k_values, batch)
            parity = pac_parity(pac, pac_base)
            summary["measurements"].append(
                {"range": label, "cluster_batch": batch,
                 "rate": round(rate, 2),
                 "speedup": round(rate / max(rate_base, 1e-9), 3),
                 "parity": parity}
            )
            if not parity["passed"]:
                # Sub-batching is bit-identical BY CONSTRUCTION (frozen
                # lanes never change) — a mismatch is a code regression.
                summary["gate_failures"].append(
                    {"candidate": batch, "range": label, "parity": parity}
                )
                summary["status"] = "parity-failed"
                continue
            if rate > best[1]:
                best = (batch, rate, parity)
        if best[0] is not None:
            record = make_record(
                "cluster_batch", bucket, int(best[0]),
                parity=best[2], rate=best[1], baseline_value=None,
                baseline_rate=rate_base, probe="cluster_batch",
                env=ctx.store.env,
                evidence={"k_values": list(k_values), "range": label},
            )
            summary["records"].append(ctx.store.save(record))
        return best

    k_all = tuple(range(2, s["k_hi"] + 1))
    if _sweep_candidates(k_all, "full") is None:
        return summary
    # Per-K refinement (the ROADMAP residual: small-K Lloyd converges
    # ~7x faster than large-K, so one global batch leaves waste): repeat
    # the A/B on the low and high halves of the K range, producing
    # sub-bucket records a matching sweep can resolve.
    if len(k_all) >= 4 and ctx.shapes != "smoke":
        mid = len(k_all) // 2
        for half, label in ((k_all[:mid], "low-K"), (k_all[mid:], "high-K")):
            if _out_of_budget(ctx, summary, f"per-K half {label}"):
                return summary
            if _sweep_candidates(half, label) is None:
                return summary
    return summary


_SPLIT_INIT_SHAPES = {
    "smoke": dict(n=240, d=8, h=32, k_hi=5, cluster_batch=8),
    "small": dict(n=800, d=16, h=64, k_hi=8, cluster_batch=16),
    # the headline shape, cluster_batch 16.
    "full": dict(n=5000, d=50, h=500, k_hi=20, cluster_batch=16, chunk=4),
}


@register(
    "split_init", "split_init",
    "Full-width k-means++ init outside the cluster_batch groups vs "
    "grouped init (bit-identical by construction): record the A/B "
    "verdict either way",
)
def probe_split_init(ctx: ProbeContext) -> Dict[str, Any]:
    from consensus_clustering_tpu_torch.config import SweepConfig
    from consensus_clustering_tpu_torch.models.kmeans import KMeans

    s = _SPLIT_INIT_SHAPES[ctx.shapes]
    summary = _summary("split_init", "split_init")
    if _out_of_budget(ctx, summary, "split_init A/B"):
        return summary
    x = _blobs(s["n"], s["d"])
    k_values = tuple(range(2, s["k_hi"] + 1))
    bucket = shape_bucket(s["n"], s["d"], s["h"], k_values)
    km = KMeans(n_init=3)

    def _measure(split):
        config = SweepConfig(
            n_samples=s["n"], n_features=s["d"], k_values=k_values,
            n_iterations=s["h"], store_matrices=False,
            chunk_size=s.get("chunk", 8),
            cluster_batch=s["cluster_batch"], split_init=split,
        )
        return _run_monolithic(km, config, x, ctx)

    ctx.log(f"split_init: A (grouped init) @ {bucket}")
    pac_a, rate_a, _ = _measure(False)
    summary["measurements"].append(
        {"split_init": False, "rate": round(rate_a, 2)}
    )
    if _out_of_budget(ctx, summary, "split_init=True arm"):
        return summary
    ctx.log("split_init: B (full-width init)")
    pac_b, rate_b, _ = _measure(True)
    parity = pac_parity(pac_b, pac_a)
    speedup = rate_b / max(rate_a, 1e-9)
    summary["measurements"].append(
        {"split_init": True, "rate": round(rate_b, 2),
         "speedup": round(speedup, 3), "parity": parity}
    )
    if not parity["passed"]:
        # Bit-identical by construction (the init keys derive the same
        # draws) — a mismatch is a code regression, not a measurement.
        summary["gate_failures"].append({"parity": parity})
        summary["status"] = "parity-failed"
        return summary
    # The A/B verdict is a record either way: value True pins the win,
    # value False commits "measured, no win" so the policy's calibrated
    # tier answers instead of re-asking the default forever (the
    # ROADMAP rule: pin only on a reproduced win).
    record = make_record(
        "split_init", bucket, bool(speedup > 1.0),
        parity=parity, rate=rate_b, baseline_value=False,
        baseline_rate=rate_a, probe="split_init",
        env=ctx.store.env,
        evidence={"cluster_batch": s["cluster_batch"],
                  "k_values": list(k_values)},
    )
    summary["records"].append(ctx.store.save(record))
    return summary


_STREAM_BLOCK_SHAPES = {
    "smoke": dict(n=200, d=8, h=48, k_hi=4, blocks=(16, 24)),
    "small": dict(n=600, d=12, h=96, k_hi=6, blocks=(16, 32, 48)),
    # The serving curve at the headline shape.
    "full": dict(n=5000, d=50, h=500, k_hi=20, blocks=(32, 64, 128),
                 chunk=4),
}


@register(
    "stream_h_block", "stream_h_block",
    "Streamed block-size curve vs the monolithic sweep (bit-identical "
    "at full H by the streaming engine's parity proof): record the "
    "fastest block",
)
def probe_stream_h_block(ctx: ProbeContext) -> Dict[str, Any]:
    from consensus_clustering_tpu_torch.config import SweepConfig
    from consensus_clustering_tpu_torch.models.kmeans import KMeans

    s = _STREAM_BLOCK_SHAPES[ctx.shapes]
    summary = _summary("stream_h_block", "stream_h_block")
    if _out_of_budget(ctx, summary, "stream_h_block baseline"):
        return summary
    x = _blobs(s["n"], s["d"])
    k_values = tuple(range(2, s["k_hi"] + 1))
    bucket = shape_bucket(s["n"], s["d"], s["h"], k_values)
    km = KMeans(n_init=3)
    base_config = SweepConfig(
        n_samples=s["n"], n_features=s["d"], k_values=k_values,
        n_iterations=s["h"], store_matrices=False,
        chunk_size=s.get("chunk", 8),
    )
    ctx.log(f"stream_h_block: monolithic baseline @ {bucket}")
    pac_base, rate_base, _ = _run_monolithic(
        km, base_config, x, ctx
    )
    summary["measurements"].append(
        {"stream_h_block": None, "rate": round(rate_base, 2)}
    )
    best: Tuple[Optional[int], float] = (None, 0.0)
    best_parity = None
    for block in s["blocks"]:
        if _out_of_budget(ctx, summary, f"stream_h_block={block}"):
            break
        ctx.log(f"stream_h_block: block {block}")
        config = dataclasses.replace(base_config, stream_h_block=block)
        pac, rate, _ = _run_streamed(km, config, x, ctx)
        parity = pac_parity(pac, pac_base)
        summary["measurements"].append(
            {"stream_h_block": block, "rate": round(rate, 2),
             "vs_monolithic": round(rate / max(rate_base, 1e-9), 3),
             "parity": parity}
        )
        if not parity["passed"]:
            # Full-H streaming is bit-exact to the monolithic program
            # — a mismatch is a code regression.
            summary["gate_failures"].append(
                {"candidate": block, "parity": parity}
            )
            summary["status"] = "parity-failed"
            continue
        if rate > best[1]:
            best = (block, rate)
            best_parity = parity
    if best[0] is not None:
        record = make_record(
            "stream_h_block", bucket, int(best[0]),
            parity=best_parity, rate=best[1],
            baseline_rate=rate_base, probe="stream_h_block",
            env=ctx.store.env,
            evidence={"k_values": list(k_values),
                      "blocks_tried": list(s["blocks"])},
        )
        summary["records"].append(ctx.store.save(record))
    return summary


_ADAPTIVE_SHAPES = {
    "smoke": dict(n=200, d=8, h=48, k_hi=4, block=16, tols=(0.02,)),
    "small": dict(n=500, d=10, h=120, k_hi=6, block=24,
                  tols=(0.02, 0.01, 0.005)),
    "full": dict(n=10000, d=50, h=1000, k_hi=20, block=64,
                 tols=(0.02, 0.01, 0.005), chunk=8),
}


@register(
    "adaptive_tol", "adaptive_tol",
    "Early-stop tolerance sweep over stable AND marginal data: the "
    "recommendation is the largest tol whose measured PAC drift stays "
    "within it on BOTH families (the defensible serving default)",
)
def probe_adaptive_tol(ctx: ProbeContext) -> Dict[str, Any]:
    from consensus_clustering_tpu_torch.config import SweepConfig
    from consensus_clustering_tpu_torch.models.kmeans import KMeans

    s = _ADAPTIVE_SHAPES[ctx.shapes]
    summary = _summary("adaptive_tol", "adaptive_tol")
    x_by_family = {
        # Well-separated clusters: PAC flattens fast (the easy win).
        "stable": _blobs(s["n"], s["d"], std=0.8),
        # Overlapping clusters: the adversarial case a serving default
        # must survive — drift shows up here first.
        "marginal": _blobs(s["n"], s["d"], std=3.5),
    }
    k_values = tuple(range(2, s["k_hi"] + 1))
    bucket = shape_bucket(s["n"], s["d"], s["h"], k_values)
    km = KMeans(n_init=3)
    base_config = SweepConfig(
        n_samples=s["n"], n_features=s["d"], k_values=k_values,
        n_iterations=s["h"], store_matrices=False,
        chunk_size=s.get("chunk", 8), stream_h_block=s["block"],
    )
    pac_full: Dict[str, List[float]] = {}
    for family, x in x_by_family.items():
        if _out_of_budget(ctx, summary, f"full-H baseline [{family}]"):
            return summary
        ctx.log(f"adaptive_tol: full-H baseline [{family}] @ {bucket}")
        pac, rate, _ = _run_streamed(km, base_config, x, ctx)
        pac_full[family] = pac
        summary["measurements"].append(
            {"family": family, "adaptive_tol": None,
             "rate": round(rate, 2)}
        )
    # Largest-to-smallest so the first tol passing both families wins.
    eligible: Optional[Dict[str, Any]] = None
    for tol in sorted(s["tols"], reverse=True):
        arms = []
        for family, x in x_by_family.items():
            if _out_of_budget(ctx, summary,
                              f"adaptive_tol={tol} [{family}]"):
                return summary
            ctx.log(f"adaptive_tol: tol={tol} [{family}]")
            config = dataclasses.replace(
                base_config, adaptive_tol=tol, adaptive_patience=2,
            )
            pac, rate, out = _run_streamed(km, config, x, ctx)
            parity = pac_parity(pac, pac_full[family], tolerance=tol)
            h_eff = int(out["streaming"]["h_effective"])
            arms.append(
                {"family": family, "adaptive_tol": tol,
                 "rate": round(rate, 2), "h_effective": h_eff,
                 "h_requested": s["h"],
                 "h_saved_fraction": round(1.0 - h_eff / s["h"], 3),
                 "parity": parity}
            )
        summary["measurements"].extend(arms)
        if eligible is None and all(a["parity"]["passed"] for a in arms):
            worst = max(a["parity"]["max_pac_delta"] for a in arms)
            eligible = {
                "tol": tol,
                "parity": {
                    "gate": "tolerance", "tolerance": tol,
                    "max_pac_delta": worst,
                    "k_values_compared": len(k_values),
                    "passed": True,
                },
                "arms": arms,
                "rate": max(a["rate"] for a in arms),
            }
        # Candidates that miss their own tolerance are simply not
        # eligible — an honest measurement, not a code regression, so
        # no gate_failures entry (a gate must not cry wolf on noise).
    if eligible is not None:
        record = make_record(
            "adaptive_tol", bucket, float(eligible["tol"]),
            parity=eligible["parity"], rate=eligible["rate"],
            probe="adaptive_tol", env=ctx.store.env,
            evidence={"k_values": list(k_values),
                      "stream_h_block": s["block"],
                      "arms": eligible["arms"]},
        )
        summary["records"].append(ctx.store.save(record))
    return summary


# -- suite driver ---------------------------------------------------------


def _warm_up(ctx: ProbeContext) -> None:
    """One untimed monolithic and one streamed fit at a tiny shape on the
    context's device.  The reference's rates exclude compilation; here
    the first fit of a process pays one-time set-up instead (the kernels'
    libraries, the allocator's pools, the math libraries' handles), which
    would otherwise be charged to whichever probe runs first."""
    from consensus_clustering_tpu_torch.config import SweepConfig
    from consensus_clustering_tpu_torch.models.kmeans import KMeans

    config = SweepConfig(n_samples=64, n_features=4, k_values=(2, 3),
                         n_iterations=4, store_matrices=False)
    x = _blobs(64, 4)
    _run_monolithic(KMeans(n_init=3), config, x, dataclasses.replace(
        ctx, repeats=1))
    _run_streamed(KMeans(n_init=3), dataclasses.replace(
        config, stream_h_block=2), x, dataclasses.replace(ctx, repeats=1))



def run_probes(
    names: Sequence[str], ctx: ProbeContext
) -> Tuple[List[Dict[str, Any]], bool]:
    """Run the named probes in order under the shared budget.

    Returns ``(summaries, gate_failed)`` — ``gate_failed`` is True when
    any probe recorded a parity-gate violation (``autotune run``'s
    non-zero exit), never merely because the budget ran out.
    """
    summaries = []
    gate_failed = False
    if not ctx.budget.exhausted():
        _warm_up(ctx)
    for name in names:
        probe = get_probe(name)
        if ctx.budget.exhausted():
            summaries.append(
                {"probe": probe.name, "knob": probe.knob,
                 "status": "budget-skipped", "records": [],
                 "measurements": [], "gate_failures": [],
                 "skipped": ["entire probe"]}
            )
            continue
        if ctx.budget.seconds is None:
            left = "unbounded"
        else:
            left = f"{ctx.budget.seconds - ctx.budget.elapsed():.0f}s left"
        ctx.log(f"probe {probe.name} (budget {left})")
        summary = probe.fn(ctx)
        summaries.append(summary)
        if summary["gate_failures"]:
            gate_failed = True
    return summaries, gate_failed
