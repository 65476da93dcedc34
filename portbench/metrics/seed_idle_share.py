"""clusterer seeding: the device's idle seconds that began while the host
was in the program's range ``cc.kmeans.seed`` (innermost), as a share of
that range's host seconds: how far seeding leaves the card waiting on
the host."""

from portbench.metrics._share import program_range


def read(record):
    entry = program_range(record, "cc.kmeans.seed")
    if entry is None or not entry["host_s"] or not record["trace"].get(
            "kernels"):
        return None
    return 100.0 * entry["idle_s"] / entry["host_s"]
