"""kernel B3 (``ops/popcount.packed_coassoc_counts_kernel`` ->
``csrc/popcount.cu``): the least time its launches' work could take on the
card (:func:`portbench.peaks.popcount_work`) over the device time of the
operations those calls launched."""

from portbench.metrics._share import roofline


def read(record):
    return roofline(record, "b3")
