"""clusterer seeding: device kernels launched with the program's range
``cc.kmeans.seed`` the innermost program range (k-means++: B5's draws and
the candidate potentials around them), per resample-K of the traced
sweep."""

from portbench.metrics._share import program_range


def read(record):
    entry = program_range(record, "cc.kmeans.seed")
    sweeps = record["sweeps"]
    if entry is None or not entry["kernels"] or not sweeps:
        return None
    return entry["kernels"] / sweeps[0]["resamples"]
