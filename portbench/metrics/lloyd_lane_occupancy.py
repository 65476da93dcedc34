"""clusterer Lloyd loop: the share of a Lloyd step's lanes still moving,
from the program's counter ``metrics_["lloyd"]`` of the traced sweep
(``lane_steps`` / ``lane_slots``, in percent): the rest are lanes that
converged and ride along in their group."""


def read(record):
    lloyd = record["program"]["metrics"].get("lloyd") or {}
    if not lloyd.get("lane_slots"):
        return None
    return 100.0 * lloyd["lane_steps"] / lloyd["lane_slots"]
