"""api: the seconds of the program's range ``cc.fit.refine`` in the traced
sweep: the estimator's exact refinement of the chosen K (its labels and
the count tiles of every pair).  Sweeps of the exact engines refine
nothing and read nothing."""

from portbench.metrics._share import program_range


def read(record):
    entry = program_range(record, "cc.fit.refine")
    return None if entry is None else entry["host_s"]
