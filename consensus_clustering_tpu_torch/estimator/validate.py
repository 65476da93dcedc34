"""Exact-vs-estimator validation harness: prove the disclosed bound.

The port of the reference package's ``estimator/validate.py``.  The
estimator ships an error band with every result (:mod:`.bounds`); this
harness runs both arms at shapes where exact is still feasible, on the
card by default (``--device cpu`` for the plain versions), measures the
actual divergence, and prints a record whose ``parity`` block says
whether the gate passed:

1. **Pair-exactness gate** (bit-identical, the hard gate): gather the
   dense sweep's ``Mij``/``Iij`` entries at the estimator's sampled
   pairs and compare the integer counts — the estimator's whole error
   model rests on "pair choice is the ONLY error source", and this
   gate is what makes that a checked property instead of a docstring
   claim.
2. **Bound gate** (tolerance): per-K ``|pac_est - pac_exact|`` must
   sit under the disclosed ``pac_error_bound`` and the sup-norm CDF
   error under ``cdf_error_bound``, at EVERY validation shape.  The
   bound is probabilistic (confidence ``1 - delta``); the harness runs
   fixed seeds, so a pass is reproducible bit for bit.

Run it::

    python -m consensus_clustering_tpu_torch.estimator.validate \\
        --shapes smoke [--device cpu] [--out record.json]

Exit status 1 on any gate failure.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

#: Validation shapes: (name, N, d, H, K tuple, n_pairs).  Small enough
#: that the dense engine still runs (matrices on), big enough that the
#: pair sample is a real subset of the population.
SMOKE_SHAPES: Tuple[Tuple[str, int, int, int, Tuple[int, ...], int], ...] = (
    ("smoke_n240", 240, 6, 24, (2, 3), 4096),
    ("smoke_n420", 420, 8, 16, (2, 3, 4), 8192),
)

FULL_SHAPES = SMOKE_SHAPES + (
    ("full_n900", 900, 10, 40, (2, 3, 4, 5), 16384),
)


def blobs(n: int, d: int, seed: int, centers: int = 3) -> np.ndarray:
    """Deterministic Gaussian blobs, the harness's data (the reference's
    generator, so both harnesses validate the same inputs)."""
    rng = np.random.default_rng(seed)
    means = rng.normal(0.0, 6.0, size=(centers, d))
    assign = rng.integers(0, centers, size=n)
    return (
        means[assign] + rng.normal(0.0, 1.0, size=(n, d))
    ).astype(np.float32)


def validate_shape(
    name: str,
    n: int,
    d: int,
    h: int,
    k_values: Sequence[int],
    n_pairs: int,
    seed: int = 23,
    device=None,
) -> Dict[str, Any]:
    """One shape's exact-vs-estimator comparison record."""
    from consensus_clustering_tpu_torch.config import SweepConfig
    from consensus_clustering_tpu_torch.estimator.bounds import (
        DEFAULT_DELTA,
        cdf_error_bound,
        pac_error_bound,
    )
    from consensus_clustering_tpu_torch.estimator.engine import (
        PairConsensusEngine,
    )
    from consensus_clustering_tpu_torch.models.kmeans import KMeans
    from consensus_clustering_tpu_torch.parallel.sweep import run_sweep

    x = blobs(n, d, seed=seed + 1)
    k_values = tuple(int(k) for k in k_values)
    exact_config = SweepConfig(
        n_samples=n, n_features=d, k_values=k_values,
        n_iterations=h, store_matrices=True,
    )
    clusterer = KMeans()
    t0 = time.perf_counter()
    exact = run_sweep(clusterer, exact_config, x, seed, device=device)
    exact_seconds = time.perf_counter() - t0

    est_config = SweepConfig(
        n_samples=n, n_features=d, k_values=k_values,
        n_iterations=h, store_matrices=False,
        stream_h_block=max(1, h // 3),
    )
    engine = PairConsensusEngine(
        clusterer, est_config, n_pairs=n_pairs, device=device
    )
    engine.warmup()
    t0 = time.perf_counter()
    est = engine.run(x, seed, h, return_state=True)
    est_seconds = time.perf_counter() - t0

    # Gate 1 — pair-exactness: the estimator's integer counts must BE
    # the dense matrix entries at the sampled pairs.
    ps = est["pair_state"]
    pi, pj = ps["pair_i"], ps["pair_j"]
    iij_dense = np.asarray(exact["iij"])[pi, pj]
    mij_dense = np.stack(
        [np.asarray(exact["mij"][i])[pi, pj] for i in range(len(k_values))]
    )
    iij_equal = bool(np.array_equal(iij_dense, ps["iij"]))
    mij_equal = bool(np.array_equal(mij_dense, ps["mij"]))

    # Gate 2 — the disclosed bound covers the observed error.
    pac_exact = np.asarray(exact["pac_area"], np.float64)
    pac_est = np.asarray(est["pac_area"], np.float64)
    pac_err = np.abs(pac_est - pac_exact)
    cdf_exact = np.asarray(exact["cdf"], np.float64)
    cdf_est = np.asarray(est["cdf"], np.float64)
    cdf_err = np.max(np.abs(cdf_est - cdf_exact), axis=-1)
    pac_bound = pac_error_bound(n_pairs, n, exact_config.parity_zeros)
    cdf_bound = cdf_error_bound(n_pairs, n, exact_config.parity_zeros)
    bound_ok = bool(
        (pac_err <= pac_bound).all() and (cdf_err <= cdf_bound).all()
    )

    return {
        "shape": name,
        "n": n, "d": d, "h": h,
        "k_values": list(k_values),
        "n_pairs": int(n_pairs),
        "pair_population": n * (n - 1) // 2,
        "seed": seed,
        "delta": DEFAULT_DELTA,
        "parity": {
            # The adaptive_tol gate's record grammar: gate kind, the
            # measured worst case, the tolerance it must sit under,
            # and the verdict — committed, never silent.
            "gate": "bound",
            "k_values_compared": len(k_values),
            "pair_counts_bit_identical": iij_equal and mij_equal,
            "max_pac_error": float(pac_err.max()),
            "pac_error_bound": float(pac_bound),
            "max_cdf_error": float(cdf_err.max()),
            "cdf_error_bound": float(cdf_bound),
            "passed": bound_ok and iij_equal and mij_equal,
        },
        "evidence": {
            "pac_exact": [float(v) for v in pac_exact],
            "pac_estimate": [float(v) for v in pac_est],
            "pac_abs_error": [float(v) for v in pac_err],
            "cdf_sup_error": [float(v) for v in cdf_err],
            "estimator_disclosure": est["estimator"],
            "exact_seconds": exact_seconds,
            "estimate_seconds": est_seconds,
            "device": est["timing"]["device"],
        },
    }


def run_validation(
    shapes: Sequence[Tuple[str, int, int, int, Tuple[int, ...], int]],
    seed: int = 23,
    device=None,
) -> Dict[str, Any]:
    """Validate every shape; the aggregate record."""
    results = [validate_shape(*shape, seed=seed, device=device)
               for shape in shapes]
    return {
        "harness": "consensus_clustering_tpu_torch/estimator/validate.py",
        "gate": "estimator_bound",
        "generated_at": round(time.time(), 3),
        "passed": all(r["parity"]["passed"] for r in results),
        "shapes": results,
    }


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        description="exact-vs-estimator bound validation harness"
    )
    parser.add_argument(
        "--shapes", choices=["smoke", "full"], default="smoke",
        help="validation shape set (full adds a larger shape)",
    )
    parser.add_argument("--seed", type=int, default=23)
    parser.add_argument(
        "--device", default=None,
        help="torch device (default cuda; 'cpu' runs the plain versions)",
    )
    parser.add_argument(
        "--out", default=None,
        help="write the aggregate JSON record here",
    )
    args = parser.parse_args(argv)
    shapes = SMOKE_SHAPES if args.shapes == "smoke" else FULL_SHAPES
    record = run_validation(shapes, seed=args.seed, device=args.device)
    blob = json.dumps(record, indent=1, sort_keys=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(blob + "\n")
    print(blob)
    for r in record["shapes"]:
        p = r["parity"]
        print(
            f"{r['shape']}: pair_counts_bit_identical="
            f"{p['pair_counts_bit_identical']} "
            f"max_pac_error={p['max_pac_error']:.6f} "
            f"<= bound={p['pac_error_bound']:.6f}: "
            f"{'PASS' if p['passed'] else 'FAIL'}",
            file=sys.stderr,
        )
    return 0 if record["passed"] else 1


if __name__ == "__main__":
    sys.exit(main())
