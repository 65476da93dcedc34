"""The control of the check: the plain reference put in the program's
place, computed in TF32 (every GEMM of KMeans in TF32, the nearest
precision below the configuration's float32 with TF32 off).

``python3 portbench/run.py ... --precision tf32`` runs the window's sweeps
through :func:`control_sweep` instead of the program; the check then
holds those answers to the float32 reference, and has to refuse them.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from portbench.check import lane_clusterer
from portbench.reference.consensus import best_k
from portbench.reference.sweep import reference_sweep, sweep_params


def control_sweep(cell: Dict[str, Any], x: np.ndarray, random_state: int,
                  device: str) -> Tuple[Dict[str, Any],
                                        Dict[int, List[torch.Tensor]]]:
    """One sweep of the cell by the reference in TF32: the harness's
    record of it and what its clusterer returned by K (KMeans's centres),
    as the program's are captured."""
    t0 = time.perf_counter()
    params = sweep_params(cell["config"], cell["workload"]["check"]["mode"],
                          cell["traffic"].get("fit"))
    ks = params["ks"]
    r = reference_sweep(params, x, random_state, ks, device, "tf32",
                        cluster=lane_clusterer(cell)[0])
    cdf, pac = dict(r["cdf"]), dict(r["pac"])
    out = {"random_state": random_state, "resamples": params["h"] * len(ks),
           "h_effective": params["h"], "ks": ks, "mode": params["mode"]}
    out["best_k"] = best_k(ks, [pac[k] for k in ks])
    if params["mode"] == "estimate":
        refined = out["refined_k"] = out["best_k"]
        out["pac_estimate_at_refined_k"] = pac[refined]
        cdf[refined], pac[refined] = (r["exact_cdf"][refined],
                                      r["exact_pac"][refined])
    out["cdf"], out["pac"] = cdf, pac
    if device == "cuda":
        torch.cuda.synchronize()
    out["fit_s"] = out["run_seconds"] = time.perf_counter() - t0
    return out, {k: [c] for k, c in r["fitted"].items() if c is not None}
