"""Percent of the card's int8 peak that the whole step reaches: the frozen
count's products of the rows answered in the counted phase, over that
phase's seconds times the peak."""
from portbench.metrics import mfu


def read(run):
    return mfu(run)
