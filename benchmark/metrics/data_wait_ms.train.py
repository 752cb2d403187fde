"""Milliseconds a step that the loop's upload stage waited for a decoded
batch: the harness's span around each next() on the decoded source and
target streams it hands the loop, summed over the window, over its steps."""

from benchmark.harness.readers import layer


def read(run):
    return layer(run, "data_wait_ms")
