"""collectives: the device seconds of NCCL's collective kernels on rank 0's
card (``trace.summarize``'s ``collective_s``) as a share of its traced
window, in percent.

An NCCL kernel runs from its launch until every peer has joined, so this
includes the time rank 0's card waited for the other processes, not only
the time the sums took.  A run on one device launches no collective and
reads nothing.
"""


def read(record):
    trace = record["trace"]
    window = trace.get("window_s")
    if not window or not trace.get("collective_s"):
        return None
    return 100.0 * trace["collective_s"] / window
