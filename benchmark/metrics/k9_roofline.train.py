"""K9, the crop and normalize of the step's input (crop.cu): its roofline share in the profiled stretch."""

from benchmark.harness.readers import roofline


def read(run):
    return roofline(run, "k9")
