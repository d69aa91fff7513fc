"""Percent of the traced phase in which no operation ran on the card (the
union of the kernel, copy and set intervals of the device trace)."""
from portbench.metrics import idle


def read(run):
    return idle(run)
