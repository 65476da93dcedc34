"""One K sweep worked out by the plain reference: the plan, KMeans for
each K, the counts and the curves, the pair estimate and the exact curve
of the chosen K of an estimated sweep.  The check and the control both
call :func:`reference_sweep`; nothing here imports the measured program.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterable, List, Optional

import numpy as np
import torch

from portbench.reference import consensus as ref


def sweep_params(config: Dict[str, Any], mode: str,
                 traffic_fit: Optional[Dict[str, Any]] = None
                 ) -> Dict[str, Any]:
    """The reference's parameters of one sweep of a configuration
    (``configs/<name>.json``) run in ``mode`` ("exact" or "estimate"),
    with the fit's keys that its traffic adds (``traffic_fit``)."""
    fit = {**config["fit"], **(traffic_fit or {})}
    k_lo, k_hi = fit["K_range"]
    n = int(config["data"]["n_samples"])
    out = {
        "n": n, "h": int(fit["n_iterations"]),
        "ks": list(range(int(k_lo), int(k_hi) + 1)),
        "n_sub": ref.subsample_rows(n, float(fit.get("subsampling", 0.8))),
        "bins": int(fit.get("bins", 20)),
        "pac_interval": tuple(fit.get("PAC_interval", (0.1, 0.9))),
        "clusterer": config["clusterer"],
        "group": fit.get("cluster_batch"), "mode": mode,
    }
    if mode == "estimate":
        out["n_pairs"] = int(fit["n_pairs"])
    return out


def reference_sweep(params: Dict[str, Any], x: np.ndarray, random_state: int,
                    ks: Iterable[int], device: str,
                    precision: str = "float32",
                    exact_ks: Optional[List[int]] = None,
                    cluster: Callable = ref.cluster,
                    relabel: Optional[Callable] = None) -> Dict[str, Any]:
    """The sweep of ``random_state`` at the Ks ``ks`` (the centre slots
    are the whole sweep's largest K, as the program lays them out).
    ``cluster`` labels every resample for one K, with
    :func:`..consensus.cluster`'s arguments and returns (KMeans), or a
    lane clusterer of ``reference/clusterers/``.  ``relabel(k, x,
    indices, labels, fitted)``, where given, returns the labels the
    counts take at K (the check's lanes that parted ways,
    :func:`portbench.check.lane_judge`).

    Returns ``cdf``, ``pac`` and ``fitted`` by K (what ``cluster``
    returned beside the labels: KMeans's centres (H, k_max, d)).  An
    exact sweep's curves are exact; an estimated sweep's are the pair
    estimates, with ``exact_cdf`` and ``exact_pac`` added at ``exact_ks``
    (default: the K the rule chooses from the estimates)."""
    ks = list(ks)
    n, bins, pac_interval = params["n"], params["bins"], params["pac_interval"]
    k_max = max(params["ks"])
    xd = torch.as_tensor(x, device=device)
    key_resample, key_cluster = ref.sweep_keys(random_state, device)
    indices = ref.resample_plan(key_resample, n, params["h"], params["n_sub"])
    estimated = params["mode"] == "estimate"
    if estimated:
        m = params["n_pairs"]
        pi, pj = ref.sample_pairs(random_state, n, m, device)
    out: Dict[str, Any] = {"cdf": {}, "pac": {}, "fitted": {},
                           "exact_cdf": {}, "exact_pac": {}}
    labels_of = {}
    for k in ks:
        labels, fitted = cluster(xd, indices, key_cluster, k, k_max,
                                 params["clusterer"], params["group"],
                                 precision)
        out["fitted"][k] = fitted
        if relabel is not None:
            labels = relabel(k, xd, indices, labels, fitted)
        if estimated:
            counts = ref.pair_hist_counts(indices, labels, n, pi, pj, bins)
            cdf, pac = ref.pair_curves(counts.cpu().numpy(), m, n,
                                       pac_interval)
            labels_of[k] = labels.to(torch.int16)
        else:
            counts = ref.exact_hist_counts(indices, labels, n, bins)
            cdf, pac = ref.curves(counts.cpu().numpy(), n, pac_interval)
        out["cdf"][k], out["pac"][k] = np.asarray(cdf), float(pac)
        del labels
    if estimated:
        if exact_ks is None:
            exact_ks = [ref.best_k(ks, [out["pac"][k] for k in ks])]
        for k in exact_ks:
            counts = ref.exact_hist_counts(indices, labels_of[k].long(), n,
                                           bins)
            cdf, pac = ref.curves(counts.cpu().numpy(), n, pac_interval)
            out["exact_cdf"][k], out["exact_pac"][k] = np.asarray(cdf), \
                float(pac)
    return out
