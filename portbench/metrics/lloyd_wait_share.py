"""clusterer Lloyd loop: host time inside the program's range
``cc.kmeans.lloyd.wait`` (each Lloyd step's ``nonzero`` of the lanes
still moving, where the host waits for the device) as a share of the
traced window.

The window is the profiled sweep's, which the light profile
(:func:`portbench.trace.profiling`: ranges, launches and device operations,
no PyTorch operators) slows by the factor the result gives as
``seconds.trace_inflation`` (that sweep's wall over the untraced ones').
"""

from portbench.metrics._share import program_share


def read(record):
    return program_share(record, "cc.kmeans.lloyd.wait")
