"""K5, the superpixel max of the refinement (segment.cu): its roofline share in the profiled stretch."""

from benchmark.harness.readers import roofline


def read(run):
    return roofline(run, "k5")
