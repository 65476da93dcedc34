"""device: the share of the traced window in which no operation ran on
the card (1 - the union of the device operations' intervals / the
window).

The window is the profiled sweep's, which the light profile
(:func:`portbench.trace.profiling`: ranges, launches and device operations,
no PyTorch operators) slows by the factor the result gives as
``seconds.trace_inflation`` (that sweep's wall over the untraced ones').
"""


def read(record):
    trace = record["trace"]
    window = trace.get("window_s")
    if not window or not trace.get("kernels"):
        return None
    return 100.0 * (1.0 - trace["busy_s"] / window)
