"""The whole forward's share of the bf16 peak over the sweep's window, in
percent: the standard model's operations of every window view served
(counts/deeplab.py)."""

from benchmark.harness.readers import mfu


def read(run):
    return mfu(run, "views", "view_flops")
