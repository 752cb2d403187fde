"""K7, the superpixel gather of the refinement (segment.cu): its roofline share in the profiled stretch."""

from benchmark.harness.readers import roofline


def read(run):
    return roofline(run, "k7")
