"""Shared by the readers: a span's host share of the traced window and
the roofline share of the device operations a span launched."""


def host_share(record, span):
    """Percent of the traced window the host spent inside ``span``; None
    where the span or the window is missing."""
    entry = record["spans"].get(span)
    window = record["trace"].get("window_s")
    if entry is None or not window or not entry["calls"]:
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
