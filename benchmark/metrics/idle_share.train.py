"""The device's idle share of the profiled training stretch, in percent."""

from benchmark.harness.readers import idle_share


def read(run):
    return idle_share(run)
