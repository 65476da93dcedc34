"""Whether the answers a run's window produced are correct: one sweep of
the window, drawn from the run's seed, worked out again by the plain
reference (:mod:`portbench.reference`) from the same data and
``random_state`` once the window has closed.

The numbers compared, each against its limit in ``workloads/<cell>.json``,
are taken at the Ks up to the data's cluster count, where a correct
float32 sweep in any order of summation gives the same partitions:

- ``centroid_gap``: the median lane's relative gap, over every lane of
  those Ks, between the centres the program's ``KMeans.fit`` returned in
  the window (captured by :class:`Capture`) and the reference's, each
  lane's |program - reference| / |reference| over its k x d values.  The
  median, not the largest: in a few lanes of ten thousand two float32
  sweeps in different orders part ways (a Lloyd step more or less where
  the shift meets the tolerance, a cluster cut at another place), which
  no precision bounds;
- ``cdf_gap``: the largest gap between the program's and the reference's
  exact consensus CDF (every such K of an exact sweep; the refined K of an
  estimated one, if it is such a K).  Where the limits name
  ``parted_lanes``, the reference counts each lane that parted ways with
  the labels the program's centres give it (below);
- ``parted_lanes``: the lanes whose centres lie more than :data:`PARTED`
  (relative) from the reference's.  Such a lane is no fault where it
  reached another fixed point of Lloyd's step, as ``fixed_point_gap``
  holds it, and its partition is then judged by the curves it gives; a
  fault that moves many lanes fails this count;
- ``fixed_point_gap``: the largest, over every lane of those Ks, relative
  gap between the program's centres and one Lloyd step from them over the
  lane's rows, in float64 (:func:`fixed_point_gaps`): about 0 at a fixed
  point, no more than the tolerance lets a lane stop short of one;
- ``est_cdf_gap``: estimated sweeps only, the largest gap between the
  sampled-pair CDF estimates (or the refined K's estimated PAC);
- ``best_k_gap``: how far the chosen K lies from the choice the rule makes
  from the reference's PACs at those Ks and the program's at the others.

Past the cluster count Lloyd splits a cluster along a path that any change
of rounding moves in many lanes, so those Ks' curves are judged only
through the choice of K.  The sweep the check takes is drawn from the seed among the first
``check.within`` sweeps of the window (the last one where fewer ran).

Each number is compared where the cell's limits name it, and a limit that
names a number nothing computes fails the check.  ``centroid_gap`` is
KMeans's; a configuration with another clusterer gets its lanes from
``reference/clusterers/<name>.py`` (:func:`lane_clusterer`), whose
optional ``numbers`` adds numbers of its own, read from what the program's
clusterer returned (captured where the configuration's ``capture`` says).
A cell across processes adds ``rank_gap`` (:func:`portbench.harness.
run_cell`): the largest gap between any rank's curves, PACs and choice of
K and rank 0's for the checked sweep.
"""

from __future__ import annotations

import sys
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from portbench.reference import consensus as ref
from portbench.reference.sweep import reference_sweep, sweep_params

#: Where the program's clusterer hands back its centres.
CLUSTERER = ("consensus_clustering_tpu_torch.models.kmeans", "KMeans", "fit")
#: A lane whose centres lie farther than this (relative) from the
#: reference's has parted ways: sound lanes lie within about 2e-6.
PARTED = 1e-3
#: Lanes whose Lloyd step from their centres is taken at once.
LANE_BLOCK = 16


def checked_index(seed: int, within: int) -> int:
    """The window's sweep the check takes, drawn from the seed."""
    rng = np.random.default_rng([seed & ((1 << 64) - 1), 0xC4EC])
    return int(rng.integers(0, max(1, within)))


class Capture:
    """Holds what each call of the wrapped clusterer method returns while
    ``on``, by K in call order: the second item of a tuple (``KMeans.fit``'s
    centres), else the whole return (``fit_predict``'s labels).  The
    method is called as ``(self, keys, x, k, ...)``; the program's tensors
    are kept, never copied or read in the window."""

    def __init__(self):
        self.on = False
        self.by_k: Dict[int, List[torch.Tensor]] = {}

    def wrap(self, fn):
        capture = self

        def fit(self, keys, x, k, *args, **kwargs):
            out = fn(self, keys, x, k, *args, **kwargs)
            if capture.on:
                capture.by_k.setdefault(int(k), []).append(
                    out[1] if isinstance(out, tuple) else out)
            return out

        fit.__wrapped__ = fn
        return fit


def lane_clusterer(cell: Dict[str, Any]
                   ) -> Tuple[Callable, Optional[Callable]]:
    """The reference's lane clusterer of the cell's configuration and its
    file's ``numbers`` (None for KMeans, and where the file has none)."""
    name = cell["config"]["clusterer"]["name"]
    if name == "KMeans":
        return ref.cluster, None
    from portbench import harness

    module = harness.reference_module(cell["bench_dir"], "clusterers", name)
    return module.cluster, getattr(module, "numbers", None)


def fixed_point_gaps(x: torch.Tensor, indices: torch.Tensor,
                     centres: torch.Tensor, k: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each lane's relative gap (L,) between its first k centres
    (L, k_max, d) and one Lloyd step from them over its rows x[indices]
    (L, n, d), in float64: every row to its nearest centre (the lowest on
    ties), each centre to its rows' mean; inf where a centre keeps no row.
    Returns the gaps and those labels (L, n)."""
    gaps, labels = [], []
    for l0 in range(0, indices.shape[0], LANE_BLOCK):
        xs = x[indices[l0:l0 + LANE_BLOCK]].double()
        c = centres[l0:l0 + LANE_BLOCK, :k].to(xs.device).double()
        dist = ((xs * xs).sum(-1, keepdim=True)
                - 2.0 * torch.matmul(xs, c.transpose(1, 2))
                + (c * c).sum(-1)[:, None, :])
        lab = dist.argmin(-1)
        onehot = torch.nn.functional.one_hot(lab, k).double()
        counts = onehot.sum(1)
        means = (torch.matmul(onehot.transpose(1, 2), xs)
                 / counts.clamp(min=1.0)[..., None])
        gap = ((means - c).flatten(1).norm(dim=1)
               / c.flatten(1).norm(dim=1).clamp(min=1e-30))
        gaps.append(torch.where((counts == 0).any(-1),
                                torch.full_like(gap, float("inf")), gap))
        labels.append(lab)
    return torch.cat(gaps), torch.cat(labels)


def lane_judge(lanes_by_k: Dict[int, torch.Tensor], found: Dict[str, Any]
               ) -> Callable:
    """The reference sweep's ``relabel``: at each K it takes every
    program lane's fixed-point gap (``lanes_by_k``: centres (H, k_max, d),
    one sweep) and counts the lanes that parted ways from the reference's,
    into ``found``'s ``fixed_point_gap`` and ``parted_lanes``; a parted
    lane's labels become those its centres give."""
    found["parted_lanes"] = 0.0
    found["fixed_point_gap"] = 0.0

    def relabel(k, x, indices, labels, fitted):
        got = lanes_by_k.get(k)
        if got is None:
            return labels
        gaps, own = fixed_point_gaps(x, indices, got, k)
        found["fixed_point_gap"] = max(found["fixed_point_gap"],
                                       float(gaps.max()))
        parted = torch.nonzero(ref.centroid_gaps(got, fitted, k)
                               > PARTED).flatten()
        found["parted_lanes"] += float(parted.numel())
        if not parted.numel():
            return labels
        labels = labels.clone()
        labels[parted] = own[parted].to(labels.device, labels.dtype)
        return labels

    return relabel


def check_sweep(cell: Dict[str, Any], x: np.ndarray, sweep: Dict[str, Any],
                centroids: Dict[int, List[torch.Tensor]], device: str,
                extra: Optional[Dict[str, float]] = None) -> Dict[str, Any]:
    """``{"correct": bool, "numbers": {name: {"value", "limit"}}}`` of one
    sweep and what its clusterer returned (``centroids``: KMeans's centres,
    or another clusterer's captured outputs); ``extra`` numbers computed
    by the caller.  The numbers are also printed, as the last lines of
    standard error."""
    config, work = cell["config"], cell["workload"]
    limits, mode = work["limits"], work["check"]["mode"]
    estimated = mode == "estimate"
    found = {"cdf_gap": 0.0}
    if estimated:
        found["est_cdf_gap"] = 0.0
    found.update(extra or {})
    notes = []
    if sweep["mode"] != mode:
        notes.append(f"the sweep ran mode {sweep['mode']!r}, the cell "
                     f"states {mode!r}")
    params = sweep_params(config, mode, cell["traffic"].get("fit"))
    h = params["h"] = int(sweep["h_effective"])
    ks = sweep["ks"]
    checked = [k for k in ks if k <= int(config["data"]["centers"])]
    refined = sweep.get("refined_k")
    exact_ks = [refined] if estimated and refined in checked else []
    cluster, numbers_of = lane_clusterer(cell)
    centres = "centroid_gap" in limits
    judged_lanes = "parted_lanes" in limits or "fixed_point_gap" in limits
    lanes_by_k = {}
    for k in checked:
        if centres or judged_lanes or numbers_of is not None:
            parts = centroids.get(k, [])
            rows = sum(int(p.shape[0]) for p in parts)
            if not rows or rows % h or (judged_lanes and rows != h):
                notes.append(f"K={k}: {rows} captured lanes, not whole "
                             f"sweeps of {h}" + (", one sweep"
                                                 if judged_lanes else ""))
            else:
                lanes_by_k[k] = torch.cat([p.to(device) for p in parts])
    relabel = lane_judge(lanes_by_k, found) if judged_lanes else None
    r = reference_sweep(params, x, sweep["random_state"], checked, device,
                        exact_ks=exact_ks, cluster=cluster, relabel=relabel)
    gaps, by_k = [], {}
    for k in checked:
        if centres:
            got = lanes_by_k.get(k)
            if got is None:
                gaps.append(torch.tensor([float("inf")]))
            else:
                at_k = torch.cat([ref.centroid_gaps(
                    got[p0:p0 + h], r["fitted"][k], k).cpu()
                    for p0 in range(0, got.shape[0], h)])
                gaps.append(at_k)
                by_k[k] = float(at_k.max())
        if estimated:
            if k == refined:
                est = abs(sweep["pac_estimate_at_refined_k"] - r["pac"][k])
                found["cdf_gap"] = max(found["cdf_gap"], float(np.abs(
                    sweep["cdf"][k] - r["exact_cdf"][k]).max()))
            else:
                est = float(np.abs(sweep["cdf"][k] - r["cdf"][k]).max())
            found["est_cdf_gap"] = max(found["est_cdf_gap"], est)
        else:
            found["cdf_gap"] = max(found["cdf_gap"], float(np.abs(
                sweep["cdf"][k] - r["cdf"][k]).max()))
    lanes = torch.cat(gaps) if gaps else torch.zeros(1)
    if centres:
        found["centroid_gap"] = float(lanes.double().median())
    if numbers_of is not None and len(lanes_by_k) == len(checked):
        found.update(numbers_of(lanes_by_k, r["fitted"], checked))
    judged = dict(sweep["pac"])
    if estimated:
        judged[refined] = sweep["pac_estimate_at_refined_k"]
    judged.update(r["pac"])
    choice = ref.best_k(ks, [judged[k] for k in ks])
    found["best_k_gap"] = float(abs(sweep["best_k"] - choice))
    for name in limits:
        if name not in found:
            notes.append(f"the limits name {name!r}, which nothing "
                         f"computed")
            found[name] = float("inf")
    numbers = {name: {"value": found[name], "limit": limits[name]}
               for name in limits}
    correct = not notes and all(v["value"] <= v["limit"]
                                for v in numbers.values())
    for note in notes:
        print(f"check: {note}", file=sys.stderr)
    print(f"check: sweep {sweep['random_state']} at K {checked}; lane "
          f"centroid gaps: largest by K {by_k}, of {lanes.numel()} lanes",
          file=sys.stderr)
    for name, v in numbers.items():
        ok = "ok" if v["value"] <= v["limit"] else "FAIL"
        print(f"check {name} {v['value']!r} limit {v['limit']!r} {ok}",
              file=sys.stderr)
    return {"correct": correct, "numbers": numbers,
            "centroid_gap_by_k": by_k}
