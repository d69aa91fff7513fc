"""Median of every request's time from the call to its answer on the
host, over all requests of the window."""
from portbench.metrics import percentile_ms


def read(run):
    return percentile_ms(run.rec.lat, 50)
