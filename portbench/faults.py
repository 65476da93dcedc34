"""Faults planted in the timed path underneath a run, each of which the
check has to refuse: the benchmark's CPU tests drive every cell with each,
and ``portbench/readings.py --fault <name>`` reads the check's numbers
with one at a cell's own size (``portbench/run.py --fault <name>`` in
every rank of a cell across processes).  :data:`FAULTS` are those any
cell can have, :data:`PROCESS_FAULTS` those of a cell across processes.
Each is a context manager that patches the program and restores it on
exit."""

import contextlib

import torch


@contextlib.contextmanager
def _patched(owner, attr, make):
    saved = getattr(owner, attr)
    setattr(owner, attr, make(saved))
    try:
        yield
    finally:
        setattr(owner, attr, saved)


def _state_unchanged():
    """The Lloyd step returns its centroids as they came, shift 0."""
    from consensus_clustering_tpu_torch.models import kmeans

    def make(fn):
        def apply_update(x, lane_src, centroids, *args):
            return centroids, torch.zeros(centroids.shape[0],
                                          dtype=centroids.dtype,
                                          device=centroids.device)
        return apply_update
    return _patched(kmeans, "_apply_update", make)


def _half_left_out():
    """Half of each lane group is left out of the counts: its labels are
    dropped (-1), or, on the fused packed path, its bits of the planes."""
    from consensus_clustering_tpu_torch.parallel import streaming, sweep

    def lanes(fn):
        def fit_resample_lanes(clusterer, config, keys, x_sub, k, k_max,
                               return_centroids=False):
            out = fn(clusterer, config, keys, x_sub, k, k_max,
                     return_centroids)
            if not return_centroids:
                out = out.clone()
                out[out.shape[0] // 2:] = -1
            return out
        return fit_resample_lanes

    def planes(fn):
        def fused_assign_pack(x_cols, centroids, k, coplanes, row0, *,
                              n_words):
            out = fn(x_cols, centroids, k, coplanes, row0, n_words=n_words)
            keep = [sum(1 << b for b in range(32)
                        if row0 <= 32 * w + b
                        < row0 + centroids.shape[0] // 2)
                    for w in range(n_words)]
            mask = torch.tensor([v - 2**32 if v >= 2**31 else v
                                 for v in keep], dtype=torch.int32,
                                device=out.device)
            return out & mask[None, :, None]
        return fused_assign_pack

    stack = contextlib.ExitStack()
    stack.enter_context(_patched(sweep, "fit_resample_lanes", lanes))
    stack.enter_context(_patched(streaming, "fused_assign_pack", planes))
    return stack


def _answer_altered():
    """The clusterer's answer altered where it is made: lane 0's first
    labels moved to the next cluster, its first centre moved away."""
    from consensus_clustering_tpu_torch.models.kmeans import KMeans

    def make(fn):
        def fit(self, keys, x, k, k_max=None, init_centroids=None):
            labels, centroids = fn(self, keys, x, k, k_max, init_centroids)
            labels, centroids = labels.clone(), centroids.clone()
            labels[0, :20] = (labels[0, :20] + 1) % k
            centroids[0, 0] += 50.0
            return labels, centroids
        return fit
    return _patched(KMeans, "fit", make)


FAULTS = {"state_unchanged": _state_unchanged,
          "half_left_out": _half_left_out,
          "answer_altered": _answer_altered}


def _exchange_left_out():
    """The sums between processes left out: each process keeps its own
    partial counts where the mesh would all-reduce them."""
    from consensus_clustering_tpu_torch.parallel import distributed

    def make(fn):
        def all_reduce(tensor, ranks):
            return None
        return all_reduce
    return _patched(distributed, "all_reduce", make)


PROCESS_FAULTS = {"exchange_left_out": _exchange_left_out}
