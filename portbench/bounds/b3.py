"""Kernel B3 (``ops/popcount.packed_coassoc_counts_kernel`` ->
``csrc/popcount.cu``): one popcount count tile
(:func:`portbench.peaks.popcount_work`)."""

from portbench import peaks

MODULE = "consensus_clustering_tpu_torch.ops.popcount"
ATTRIBUTE = "packed_coassoc_counts_kernel"


def bound_ms(config, row_words, col_words, *args, **kwargs) -> float:
    words, rows = row_words.shape
    return peaks.popcount_bound_ms(words, rows, col_words.shape[1])
