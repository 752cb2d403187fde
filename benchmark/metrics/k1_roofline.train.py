"""K1, the instance norm forward (insnorm.cu): its roofline share in the profiled stretch."""

from benchmark.harness.readers import roofline


def read(run):
    return roofline(run, "k1")
