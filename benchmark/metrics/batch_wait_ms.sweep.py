"""Milliseconds a batch that the sweep waited in next() on predict_batches
(the decode and upload stages and the predictor's call), over the window."""

from benchmark.harness.readers import layer


def read(run):
    return layer(run, "batch_wait_ms")
