"""Mean microseconds a request waited in the batcher's queue, admission to
flush, over every request of the counted phase (the program's queue
span, read from its Tracer's histogram)."""
from portbench.metrics import phase_a


def read(run):
    a = phase_a(run)
    if a is None or not a["counters"].get("queue_n"):
        return None
    return a["counters"]["queue_sum_us"] / a["counters"]["queue_n"]
