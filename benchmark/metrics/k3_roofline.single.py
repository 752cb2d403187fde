"""K3, the eval tail (tail.cu), in the single-tile requests: its roofline
share in the profiled stretch."""

from benchmark.harness.readers import roofline


def read(run):
    return roofline(run, "k3")
