"""A plain average-linkage agglomeration as a lane clusterer of
``reference/clusterers/`` (the tests copy it there as
``AgglomerativeClustering.py``): the by-name lookup's example of a
clusterer other than KMeans.

Each lane's subsample is agglomerated on its float64 Euclidean distances,
merging the closest pair of live clusters (the lowest pair on ties) and
averaging the merged row, until k clusters are left.  The parameters it
returns are the labels themselves, which ``numbers`` holds the program's
captured labels to as partitions.  ``LINKAGE`` "single" makes the
deliberately wrong reference of the tests.
"""

from typing import Dict, List

import torch

LINKAGE = "average"


def _agglomerate(x: torch.Tensor, k: int) -> torch.Tensor:
    n = x.shape[0]
    d = torch.cdist(x, x)
    d.fill_diagonal_(float("inf"))
    size = torch.ones(n, dtype=torch.float64)
    rep = torch.arange(n)
    live = torch.ones(n, dtype=torch.bool)
    for _ in range(n - k):
        flat = int(torch.argmin(d))
        i, j = sorted((flat // n, flat % n))
        if LINKAGE == "average":
            row = (size[i] * d[i] + size[j] * d[j]) / (size[i] + size[j])
        else:
            row = torch.minimum(d[i], d[j])
        live[j] = False
        row[~live] = float("inf")
        row[i] = float("inf")
        d[i], d[:, i] = row, row
        d[j], d[:, j] = float("inf"), float("inf")
        size[i] += size[j]
        rep[rep == rep[j]] = rep[i]
    order = torch.cumsum(live.long(), 0) - 1
    return order[rep]


def cluster(x, indices, key_cluster, k, k_max, clusterer, group, precision):
    """(labels (H, n_sub), the same labels) of every resample."""
    labels = torch.stack([_agglomerate(x[idx].double().cpu(), k)
                          for idx in indices]).to(x.device)
    return labels, labels


def _same_partition(a: torch.Tensor, b: torch.Tensor) -> bool:
    pairs = torch.unique(a * (int(b.max()) + 1) + b).numel()
    return pairs == torch.unique(a).numel() == torch.unique(b).numel()


def numbers(captured: Dict[int, torch.Tensor], fitted: Dict[int, torch.Tensor],
            ks: List[int]) -> Dict[str, float]:
    """``label_gap``: the share of lanes whose captured partition is not
    the reference's."""
    lanes = [_same_partition(got.cpu(), want.cpu())
             for k in ks for got, want in zip(captured[k], fitted[k])]
    return {"label_gap": 1.0 - sum(lanes) / len(lanes)}
