"""Kernel B2 (``ops/lloyd.lloyd_step_kernel`` -> ``csrc/lloyd.cu``): one
Lloyd step over a call's lanes (:func:`portbench.peaks.lloyd_step_work`),
reading the fewest distinct subsamples its lanes can read when each
carries the clusterer's ``n_init`` restarts."""

from portbench import peaks

MODULE = "consensus_clustering_tpu_torch.ops.lloyd"
ATTRIBUTE = "lloyd_step_kernel"


def bound_ms(config, x, lane_src, centroids, k, *args, **kwargs) -> float:
    resamples, rows, d = x.shape
    lanes = centroids.shape[0]
    n_init = int(config["clusterer"].get("n_init", 1))
    return peaks.lloyd_step_bound_ms(
        peaks.lloyd_resamples_read(lanes, resamples, n_init), rows, d,
        lanes, int(k))
