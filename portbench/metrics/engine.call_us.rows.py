"""Host microseconds of one bucket call (staging, copies, replay, sync),
over the counted phase: the batcher's timing of each flush's call, or the
harness's own span around each predict_q_many call divided by its chunks."""
from portbench.metrics import phase_a


def read(run):
    a = phase_a(run)
    if a is None or not a["calls"]:
        return None
    return 1e6 * a["counters"]["call_s"] / a["calls"]
