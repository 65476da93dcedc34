"""clusterer Lloyd loop: host trips of the Lloyd loop per run of it in
the traced sweep, from the program's counter ``metrics_["lloyd"]``
(``steps`` / ``fits``; the engine's sweep, not the estimator's exact
refinement, which ``metrics_["exact_best_k"]`` counts apart)."""


def read(record):
    lloyd = record["program"]["metrics"].get("lloyd") or {}
    if not lloyd.get("fits"):
        return None
    return lloyd["steps"] / lloyd["fits"]
