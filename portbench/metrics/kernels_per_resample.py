"""clusterer launches: device kernels the profiler saw in the traced
window (PyTorch's and the port's), per resample-K of that window's
sweep."""


def read(record):
    trace, sweeps = record["trace"], record["sweeps"]
    if not trace.get("kernels") or not sweeps:
        return None
    return trace["kernels"] / sweeps[0]["resamples"]
