"""95th percentile of the served requests' host times, call to answer, over
the counted phase of a traced run: above capacity it swings with the
queue, so it is a layer's reading here and not an end-to-end bound."""
from portbench.metrics import percentile_ms


def read(run):
    a = run.rec.phase_a
    return None if a is None else percentile_ms(run.rec.lat[:a["requests"]],
                                                95)
