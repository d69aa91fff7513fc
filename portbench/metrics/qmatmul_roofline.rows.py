"""Percent of its roofline that the qmatmul kernel reaches over the traced
phase: the frozen count of the FC and CONV_2D layers for the rows answered,
over the summed time of the qmatmul kernel (not the im2col copies)."""
from portbench.metrics import is_qmatmul, roofline


def read(run):
    return roofline(run, ("fc", "conv"), is_qmatmul)
