"""Rows a flush carried, over the counted phase (the batcher's own
counts)."""
from portbench.metrics import phase_a


def read(run):
    a = phase_a(run)
    if a is None or not a["calls"] or "batches" not in a["counters"]:
        return None
    return a["rows"] / a["calls"]
