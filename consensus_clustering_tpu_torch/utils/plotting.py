# Copied from consensus_clustering_tpu/utils/plotting.py.
"""Consensus figures: per-K CDF, Δ(K) elbow, consensus-matrix heatmap.

The CDF figure carries the same information as the reference's
(consensus_clustering_parallelised.py:389-410 — per-K CDF curves with the
PAC interval marked) but an owned visual design, not a transcription of the
GPL original's style constants:

- K is an *ordinal* dimension, so the curves wear one sequential hue
  (light -> dark with increasing K) instead of cycled categorical colors —
  the eye reads the K ordering directly off the ramp.
- the PAC interval is a shaded band (the region whose CDF mass defines the
  PAC score) rather than bare vlines, labeled in the legend.
- recessive axes: no top/right spines, light dotted grid under the data.
- curves start at the origin (a 0 is prepended to each CDF) because the
  CDF of a distribution on [0, 1] is 0 at 0 — semantics, not styling.

Δ(K) and the consensus-matrix heatmap have no reference analog: the
reference stores their ingredients (areas, Cij) but never draws them.

matplotlib is imported lazily so headless/benchmark runs never pay for it.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np


def _pyplot(show: bool):
    """Lazy pyplot, on the Agg backend when the figure will not be shown."""
    import matplotlib

    if not show:
        matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    return plt


def _style_axes(ax) -> None:
    """The shared recessive-axes look: dotted under-grid, open spines."""
    ax.grid(True, linestyle=":", linewidth=0.6, color="0.85", zorder=0)
    ax.set_axisbelow(True)
    for side in ("top", "right"):
        ax.spines[side].set_visible(False)


def _finish(fig, plt, show: bool, save_path: str | None):
    if save_path:
        fig.savefig(save_path)
    if show:
        plt.show()
    return fig


def plot_cdf(
    cdf_at_K_data: Dict[int, dict],
    pac_interval: Tuple[float, float] = (0.1, 0.9),
    show: bool = True,
    save_path: str | None = None,
):
    plt = _pyplot(show)
    fig, ax = plt.subplots(figsize=(6.0, 4.2), dpi=110)

    ks = sorted(cdf_at_K_data)
    # One-hue sequential ramp over the K order, clipped away from the
    # near-white end so the lightest curve stays readable on white.
    cmap = plt.get_cmap("Blues")
    lo, hi = 0.35, 0.95
    for i, k in enumerate(ks):
        data = cdf_at_K_data[k]
        x = data["bin_edges"]
        y = [0.0] + list(data["cdf"])
        frac = lo if len(ks) == 1 else lo + (hi - lo) * i / (len(ks) - 1)
        ax.plot(x, y, color=cmap(frac), linewidth=1.8, label=f"K = {k}")

    u1, u2 = pac_interval
    ax.axvspan(
        u1, u2, color="0.55", alpha=0.12, zorder=0,
        label=f"PAC interval [{u1:g}, {u2:g}]",
    )

    ax.set_xlim(0.0, 1.0)
    ax.set_ylim(0.0, 1.05)
    ax.set_xlabel("consensus index value")
    ax.set_ylabel("CDF")
    _style_axes(ax)
    ax.legend(
        frameon=False, fontsize=8, ncol=2 if len(ks) > 8 else 1,
        loc="lower right",
    )
    fig.tight_layout()
    return _finish(fig, plt, show, save_path)


def plot_delta_k(
    k_values,
    areas,
    deltas=None,
    show: bool = True,
    save_path: str | None = None,
):
    """Monti's K-selection elbow: area under the consensus CDF per K (top)
    and its relative gain Δ(K) (bottom).

    The reference computes neither curve (its user eyeballs the CDF fan);
    this framework computes both (``ConsensusClustering.areas_`` /
    ``.delta_k_``) and this figure is how they are read: pick the largest K
    whose Δ(K) is still above the flat tail.

    Args:
      k_values: the swept K values, ascending.
      areas: A(K), area under the consensus CDF per K (same order).
      deltas: Δ(K); computed from ``areas`` per Monti's definition
        (ops.analysis.delta_k) when omitted.
    """
    plt = _pyplot(show)

    ks = np.asarray(list(k_values))
    areas = np.asarray(areas, float)
    if deltas is None:
        from consensus_clustering_tpu_torch.ops.analysis import (
            delta_k as _delta,
        )

        deltas = _delta(areas)
    deltas = np.asarray(deltas, float)

    fig, (ax_a, ax_d) = plt.subplots(
        2, 1, figsize=(6.0, 4.8), dpi=110, sharex=True,
        layout="constrained",
    )
    color = plt.get_cmap("Blues")(0.75)
    for ax, y, label in ((ax_a, areas, "A(K)"), (ax_d, deltas, "Δ(K)")):
        ax.plot(ks, y, color=color, linewidth=1.8, marker="o", markersize=4)
        ax.set_ylabel(label)
        _style_axes(ax)
    ax_d.set_xlabel("K")
    ax_d.set_xticks(ks)
    return _finish(fig, plt, show, save_path)


def plot_consensus_matrix(
    cij,
    labels=None,
    show: bool = True,
    save_path: str | None = None,
):
    """Consensus-matrix heatmap, optionally ordered by consensus labels.

    The classic consensus-clustering readout (Monti 2003 fig. 1): with rows
    and columns sorted so same-label items are adjacent, a stable K shows
    crisp white-to-dark blocks on the diagonal; ambiguous clusterings smear.
    The reference stores ``cij`` but never draws it.

    Args:
      cij: (N, N) consensus matrix, values in [0, 1].
      labels: optional (N,) labels; items are ordered by a stable sort on
        them (ties keep input order) so blocks align with clusters.
    """
    plt = _pyplot(show)

    cij = np.asarray(cij)
    if labels is not None:
        order = np.argsort(np.asarray(labels), kind="stable")
        cij = cij[np.ix_(order, order)]

    fig, ax = plt.subplots(figsize=(5.2, 4.6), dpi=110, layout="constrained")
    im = ax.imshow(
        cij, cmap="Blues", vmin=0.0, vmax=1.0, interpolation="nearest",
    )
    fig.colorbar(im, ax=ax, label="consensus index", fraction=0.046)
    ax.set_xlabel("item (consensus order)" if labels is not None else "item")
    ax.set_ylabel(ax.get_xlabel())
    for side in ("top", "right"):
        ax.spines[side].set_visible(False)
    return _finish(fig, plt, show, save_path)
