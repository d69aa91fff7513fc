"""Bytes the engine copied from the host to the card for each row
answered, over the counted phase (CompiledModel.h2d_bytes)."""
from portbench.metrics import phase_a


def read(run):
    a = phase_a(run)
    if a is None or not a["rows"]:
        return None
    return a["counters"]["h2d_bytes"] / a["rows"]
