"""api: the seconds a sweep's ``ConsensusClustering.fit`` spends outside
its engine's run, averaged over the run's sweeps (the fit's host wall
minus the engine's ``metrics_["run_seconds"]``): validation, mode
resolution, result assembly and, in an estimated sweep, the exact
refinement of the chosen K."""


def read(record):
    sweeps = record["sweeps"]
    if not sweeps:
        return None
    return sum(s["fit_s"] - s["run_seconds"] for s in sweeps) / len(sweeps)
