"""Percent of the roofline that all kernels reach over the traced phase: the
frozen count of the rows answered (not the pad rows of a bucket), max of
products over the int8 peak and bytes over the memory bandwidth, over the
summed time of every kernel in the device trace."""
from portbench.metrics import roofline


def read(run):
    return roofline(run)
