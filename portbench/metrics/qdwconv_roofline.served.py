"""Percent of its roofline that the qdwconv kernel reaches over the traced
phase: the frozen count of the DEPTHWISE_CONV_2D layers for the rows
answered, over the summed time of the qdwconv kernel."""
from portbench.metrics import is_qdwconv, roofline


def read(run):
    return roofline(run, ("dwconv",), is_qdwconv)
