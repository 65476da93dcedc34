"""Shared by the readers: a program range's entry and its host share of
the traced window, and the roofline share of the device operations a
benchmark span launched."""


def program_range(record, name):
    """The traced sweep's entry of the program range ``name``
    (:func:`portbench.trace.summarize_program`), None where it never
    opened."""
    entry = record["program"]["ranges"].get(name)
    return entry if entry and entry["calls"] else None


def program_share(record, name):
    """Percent of the traced window the host spent inside the program
    range ``name``; None where the range or the window is missing."""
    entry = program_range(record, name)
    window = record["trace"].get("window_s")
    if entry is None or not window:
        return None
    return 100.0 * entry["host_s"] / window


def roofline(record, span):
    """Percent: the least time the span's calls could take on the card
    (their bounds, from their inputs' shapes) over the device time of the
    operations launched inside it; None where either is missing."""
    entry = record["spans"].get(span)
    device_s = record["trace"].get("device_s_by_range", {}).get(span)
    if entry is None or not entry["calls"] or not device_s:
        return None
    return 100.0 * entry["bound_ms"] * 1e-3 / device_s
