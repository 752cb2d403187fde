"""Milliseconds of a request's latency outside its predictor replay on the
device (CUDA events around the call): upload, normalize, argmax, readback
and Python, averaged over the window's requests."""

from benchmark.harness.readers import layer


def read(run):
    return layer(run, "host_ms")
