"""The device's idle share of the profiled stretch of sweep batches, in
percent."""

from benchmark.harness.readers import idle_share


def read(run):
    return idle_share(run)
