"""The whole train step's share of the bf16 peak over the window, in
percent: the standard model's forward and backward operations of every
step (counts/deeplab.py)."""

from benchmark.harness.readers import mfu


def read(run):
    return mfu(run, "steps", "step_flops")
