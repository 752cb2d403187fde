"""The device's idle share of the profiled stretch of single-tile requests,
in percent: the host's part of each request, between replays."""

from benchmark.harness.readers import idle_share


def read(run):
    return idle_share(run)
