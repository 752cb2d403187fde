"""K8, the stage-3 mining (mine.cu): its roofline share in the profiled stretch."""

from benchmark.harness.readers import roofline


def read(run):
    return roofline(run, "k8")
