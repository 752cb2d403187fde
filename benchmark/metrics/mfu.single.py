"""The whole request's share of the bf16 peak while the device works on it,
in percent: the standard model's operations of the window views of the
profiled stretch's requests (counts/deeplab.py), whatever computes them
(here the fast path), over the device's busy time in the stretch (the
union of its events: upload, normalize, the replay, argmax, readback). The
window's own rate is the offered one, so its time says nothing of the
program."""

from benchmark.harness.readers import mfu_busy


def read(run):
    return mfu_busy(run, "request_flops")
