"""Confidence bounds for the sampled-pair PAC/CDF estimator.

A copy of the reference package's ``estimator/bounds.py`` (the port
imports nothing of that package).  Stdlib-only (``math``): the memory
preflight (:mod:`..serve.preflight`) sizes and discloses the estimator
from it without importing torch.

The model: the sampler draws ``M`` i.i.d. uniform pairs from the
``T = N(N-1)/2`` upper-triangle population (with replacement —
:mod:`.sampler`), and each sampled
pair's consensus value is BIT-EXACT (the engine accumulates the same
integer counts the dense engine holds at that pair), so the only
approximation is which pairs were looked at.  The empirical CDF
``F_M`` of M i.i.d. draws from the pair-value distribution ``F``
satisfies the Dvoretzky–Kiefer–Wolfowitz inequality (with Massart's
tight constant)::

    P( sup_x |F_M(x) - F(x)| > eps ) <= 2 exp(-2 M eps^2)

so with probability ``1 - delta``::

    sup_x |F_M(x) - F(x)| <= eps(M, delta) = sqrt(ln(2/delta) / (2M))

Two exact transformations ride on top:

- **Parity-zeros dilution** (quirk Q6): the reference's histogram runs
  over the full ``triu(.., k=1)`` N^2 array, so the reported CDF is
  ``(T·F(x) + Z) / N^2`` with ``Z = N(N+1)/2`` structural zeros — a
  DETERMINISTIC affine map of ``F``, so the estimator applies it
  exactly and the CDF error scales by ``T / N^2 < 1/2``.
- **PAC is a difference of two CDF values** (quirk Q7), so its error
  is at most ``2·eps`` (before dilution): ``|PAC_M - PAC| <=
  2·eps·scale``.

The disclosed per-K bound is therefore identical for every K (same M,
same N); it is reported per K anyway because that is the shape clients
consume PAC in.  Validation that the bound covers reality where exact
is still feasible: :mod:`.validate`
(``python -m consensus_clustering_tpu_torch.estimator.validate``).
"""

from __future__ import annotations

import math
from typing import Any, Dict

#: Default confidence for the disclosed band: the bound holds with
#: probability 1 - DEFAULT_DELTA over the pair draw.  Fixed rather
#: than a knob — every disclosure names it, and one fewer free
#: parameter keeps "the bound" one number per (N, M).
DEFAULT_DELTA = 1e-3

#: Default pair-sample cap: 2^17 draws put the raw DKW epsilon at
#: ~0.0054 (delta 1e-3) — a PAC band of ~0.011 before parity dilution,
#: comparable to the adaptive_tol default of 0.01 — while keeping the
#: accumulator state at ~1 MB per K (int32), i.e. O(M) where the dense
#: engine needs O(N^2).
DEFAULT_MAX_PAIRS = 131_072


def default_n_pairs(n: int) -> int:
    """The pair-sample size used when a job doesn't pin ``n_pairs``:
    the cap, or the whole population when it is smaller.  A pure
    function of N — the serving fingerprint/dedup story needs the
    default to be deterministic."""
    n = int(n)
    population = n * (n - 1) // 2
    return max(1, min(DEFAULT_MAX_PAIRS, population))


def dkw_epsilon(m: int, delta: float = DEFAULT_DELTA) -> float:
    """One-sided-sup DKW band ``sqrt(ln(2/delta) / (2m))`` for the
    empirical CDF of ``m`` i.i.d. draws, at confidence ``1 - delta``."""
    m = int(m)
    if m < 1:
        raise ValueError(f"need m >= 1 samples, got {m}")
    if not 0.0 < delta < 1.0:
        raise ValueError(f"delta must be in (0, 1), got {delta}")
    return math.sqrt(math.log(2.0 / delta) / (2.0 * m))


def pair_cdf_scale(n: int, parity_zeros: bool = True) -> float:
    """Factor the pair-CDF error shrinks by in the REPORTED curves.

    Under parity mode the reported CDF mixes the estimated pair CDF
    with ``N(N+1)/2`` deterministic zeros over an N^2 denominator, so
    estimation error enters scaled by ``T/N^2``; corrected
    (pairs-only) mode reports the pair CDF directly (scale 1).
    """
    n = int(n)
    if not parity_zeros:
        return 1.0
    return (n * (n - 1) / 2.0) / (float(n) * float(n))


def cdf_error_bound(
    m: int, n: int, parity_zeros: bool = True,
    delta: float = DEFAULT_DELTA,
) -> float:
    """Sup-norm bound on the reported CDF's estimation error, with
    probability ``1 - delta`` over the pair draw."""
    return dkw_epsilon(m, delta) * pair_cdf_scale(n, parity_zeros)


def pac_error_bound(
    m: int, n: int, parity_zeros: bool = True,
    delta: float = DEFAULT_DELTA,
) -> float:
    """Bound on ``|PAC_estimate - PAC_exact|`` (a difference of two
    CDF values: at most twice the CDF band), with probability
    ``1 - delta``."""
    return 2.0 * cdf_error_bound(m, n, parity_zeros, delta)


def bound_disclosure(
    m: int, n: int, parity_zeros: bool = True,
    delta: float = DEFAULT_DELTA,
) -> Dict[str, Any]:
    """The JSON-able error-bound block every estimator result carries
    — the never-silent rule applied to an
    approximation: a client must never consume an estimated PAC
    without its band in the same payload."""
    population = int(n) * (int(n) - 1) // 2
    return {
        "n_pairs": int(m),
        "pair_population": population,
        "pair_coverage": (
            float(m) / population if population else 1.0
        ),
        "delta": float(delta),
        "confidence": 1.0 - float(delta),
        "cdf_epsilon": dkw_epsilon(m, delta),
        "cdf_error_bound": cdf_error_bound(m, n, parity_zeros, delta),
        "pac_error_bound": pac_error_bound(m, n, parity_zeros, delta),
        "model": (
            "DKW/Massart band on the empirical CDF of M i.i.d. "
            "uniform upper-triangle pairs; sampled-pair counts are "
            "bit-exact, so pair choice is the only error source "
            "(estimator/bounds.py)"
        ),
    }
