"""kernel B2 (``ops/lloyd.lloyd_step_kernel`` -> ``csrc/lloyd.cu``): the
least time its launches' work could take on the card (from each call's
shapes, :func:`portbench.peaks.lloyd_step_work`) over the device time of
the operations those calls launched."""

from portbench.metrics._share import roofline


def read(record):
    return roofline(record, "b2")
