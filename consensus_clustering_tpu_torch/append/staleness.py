"""Has the clustering moved?  DKW-backed staleness verdict for appends.

An append reuses the old generations' counts verbatim, so the honest
question is whether the consensus structure the old lanes measured is
still the structure of the grown dataset.  The cheap, already-computed
witnesses are the two generations' consensus CDFs **over the old rows**
(the population both generations actually sampled): the old
generation's lanes clustered N_old rows, the new generation's lanes
clustered N_old + dN rows — restricted to the old-row pairs, both
estimate the same family of co-clustering probabilities, and their
sup-norm CDF distance is the drift statistic.

The bound reuses :mod:`..estimator.bounds`'s
DKW machinery, with the model disclosed rather than oversold: each
generation's empirical CDF is treated as an m-sample estimate with
``m = max(1, round(H * subsampling^2))`` — the expected number of
co-samples any fixed pair receives over H resamples (the same
heuristic population the estimator's pair coverage discloses), NOT an
i.i.d. pair draw, so the band is a calibration-family bound, not a
theorem.  Two one-sided bands compose by the triangle inequality
(``sup|F_old - F_new| <= eps_old + eps_new`` when neither moved), and
the parity-zeros dilution rescales exactly as in
:func:`..estimator.bounds.pair_cdf_scale`:
both CDFs share identical structural bin-0 mass, so their DIFFERENCE
lives on the pairs-only scale times T/N².

``refresh_recommended`` is the service verdict: drift in excess of the
bound means the observed movement cannot be explained by lane-sampling
noise at confidence ``1 - delta`` — schedule a full recompute.  Drift
within the bound keeps serving appends at marginal cost.

The port of the reference package's ``append/staleness.py``.  The two
generations' CDFs over the old rows are counted on the planes' device
(:func:`..ops.tiles.planes_curves`: the popcount and histogram kernels on
the card) where the reference runs a host popcount loop; the counts are
the same integers, so the report is the reference's to the bit.
"""

from __future__ import annotations

from typing import Any, Dict, Sequence

import numpy as np

from consensus_clustering_tpu_torch.device import resolve_device
from consensus_clustering_tpu_torch.estimator.bounds import (
    DEFAULT_DELTA,
    dkw_epsilon,
    pair_cdf_scale,
)
from consensus_clustering_tpu_torch.ops.tiles import plane_words, planes_curves


def _cdfs_over_old_rows(
    planes,
    coplanes,
    n_old: int,
    bins: int,
    pac_lo_idx: int,
    pac_hi_idx: int,
    parity_zeros: bool,
    device,
) -> list:
    """Per-K consensus CDFs restricted to the first ``n_old`` rows, counted
    on ``device``."""
    curves = planes_curves(
        plane_words(planes, device), plane_words(coplanes, device), bins,
        pac_lo_idx, pac_hi_idx, parity_zeros, n_rows=n_old,
    )
    return list(curves["cdf"])


def generation_epsilon(
    h: int, subsampling: float, delta: float = DEFAULT_DELTA
) -> float:
    """One generation's DKW band half-width on the pairs-only scale.

    ``m = max(1, round(H * subsampling^2))`` — the expected co-sample
    count of any fixed pair over H resamples at rate ``subsampling``
    (each endpoint is drawn independently per resample).
    """
    m = max(1, int(round(int(h) * float(subsampling) ** 2)))
    return float(dkw_epsilon(m, delta))


def staleness_report(
    old_arrays: Dict[str, np.ndarray],
    new_arrays: Dict[str, np.ndarray],
    *,
    n_old: int,
    k_values: Sequence[int],
    h_old: int,
    h_new: int,
    subsampling: float,
    bins: int,
    pac_lo_idx: int,
    pac_hi_idx: int,
    parity_zeros: bool = True,
    delta: float = DEFAULT_DELTA,
    device=None,
) -> Dict[str, Any]:
    """Judge drift between the old and new lane generations.

    ``old_arrays`` is the parent store's cumulative plane set (element
    axis >= n_old), ``new_arrays`` the fresh generation's (element
    axis >= n_old; typically n_new) — both are restricted to the old
    rows here; uint32 or int32 words, numpy or tensors, counted on
    ``device`` (default ``cuda``).  Returns a JSON-able report: per-K
    sup-norm CDF drift, the maximum, the disclosed bound, the excess, and
    the ``refresh_recommended`` verdict.
    """
    device = resolve_device(device)
    old_cdfs = _cdfs_over_old_rows(
        old_arrays["planes"], old_arrays["coplanes"],
        n_old, bins, pac_lo_idx, pac_hi_idx, parity_zeros, device,
    )
    new_cdfs = _cdfs_over_old_rows(
        new_arrays["planes"], new_arrays["coplanes"],
        n_old, bins, pac_lo_idx, pac_hi_idx, parity_zeros, device,
    )
    per_k = {}
    for k, old_cdf, new_cdf in zip(k_values, old_cdfs, new_cdfs):
        per_k[str(int(k))] = float(
            np.max(np.abs(
                old_cdf.astype(np.float64) - new_cdf.astype(np.float64)
            ))
        )
    drift = max(per_k.values()) if per_k else 0.0
    scale = float(pair_cdf_scale(int(n_old), parity_zeros))
    eps_old = generation_epsilon(h_old, subsampling, delta)
    eps_new = generation_epsilon(h_new, subsampling, delta)
    bound = (eps_old + eps_new) * scale
    excess = max(0.0, drift - bound)
    return {
        "drift": float(drift),
        "per_k_drift": per_k,
        "bound": float(bound),
        "drift_excess": float(excess),
        "refresh_recommended": bool(excess > 0.0),
        "h_old": int(h_old),
        "h_new": int(h_new),
        "n_old": int(n_old),
        "delta": float(delta),
        "confidence": 1.0 - float(delta),
        "epsilon_old": float(eps_old),
        "epsilon_new": float(eps_new),
        "pair_cdf_scale": scale,
        "model": (
            "sup-norm CDF drift over the old rows between lane "
            "generations, judged against a DKW band with m = "
            "round(H * subsampling^2) expected co-samples per pair "
            "and generation bands composed by triangle inequality; "
            "heuristic sampling model, disclosed not proven — see "
            "append/staleness.py"
        ),
    }
