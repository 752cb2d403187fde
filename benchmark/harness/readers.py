"""What the per-layer metrics read from a run.

A run (a driver's result) holds ``layer`` (the harness's spans and the
work counted in the window) and, for a traced run on the card,
``stretch`` (the profiled stretch's summary), ``stretch_launches`` (the
kernel wrappers' launches in it), ``stretch_work`` and ``kernel_calls``
(each kernel's launch shapes). A reader returns None where the run holds
nothing for it, and the harness then leaves the metric out.
"""

from typing import Optional

from benchmark.counts.kernels import (
    COUNTS,
    EVENTS_PER_LAUNCH,
    KERNEL_PATTERNS,
    WRAPPERS,
)
from benchmark.harness.device import HBM_BYTES_PER_S, PEAK_BF16_FLOPS
from benchmark.harness.trace import kernel_ns


def layer(run: dict, key: str) -> Optional[float]:
    return run.get("layer", {}).get(key)


def idle_share(run: dict) -> Optional[float]:
    """Percent of the profiled stretch's wall time in which no operation
    ran on the device."""
    st = run.get("stretch")
    if not st or not st["busy_ns"] or not st["wall_ns"]:
        return None
    return 100.0 * (1.0 - st["busy_ns"] / st["wall_ns"])


def mfu(run: dict, work: str, flops: str) -> Optional[float]:
    """Percent of the bf16 peak: the operations of the window's work over
    the window's time."""
    lay = run.get("layer", {})
    if not lay.get(work) or not lay.get("window_s"):
        return None
    return 100.0 * lay[work] * lay[flops] / lay["window_s"] / PEAK_BF16_FLOPS


def mfu_busy(run: dict, flops: str) -> Optional[float]:
    """Percent of the bf16 peak: the operations of the profiled stretch's
    work (``stretch_work`` units of ``flops`` each) over the time in which
    the device was busy there."""
    st, lay = run.get("stretch"), run.get("layer", {})
    if not st or not st["busy_ns"] or not lay.get(flops):
        return None
    ops = run["stretch_work"] * lay[flops]
    return 100.0 * ops / (st["busy_ns"] / 1e9) / PEAK_BF16_FLOPS


def launch_check(run: dict) -> dict:
    """{kernel: (wrapper launches, trace events, events expected)} of the
    stretch, for every kernel whose launches the run counts."""
    st, out = run.get("stretch"), {}
    for kernel in run.get("kernel_calls", {}):
        launches = run["stretch_launches"].get(WRAPPERS[kernel], 0)
        _, events = kernel_ns(st, KERNEL_PATTERNS[kernel])
        out[kernel] = (launches, events,
                       launches * EVENTS_PER_LAUNCH.get(kernel, 1))
    return out


def roofline(run: dict, kernel: str) -> Optional[float]:
    """Percent: the least time the kernel's launches in the stretch could
    take (the larger of operations at the bf16 peak and bytes at the
    memory bandwidth, per launch) over their summed device time. None
    where the trace's events of the kernel are not the wrappers' launches
    times the device functions a launch runs: the count or the time would
    then be another's."""
    st, calls = run.get("stretch"), run.get("kernel_calls", {})
    if not st or kernel not in calls:
        return None
    launches = run["stretch_launches"].get(WRAPPERS[kernel], 0)
    ns, events = kernel_ns(st, KERNEL_PATTERNS[kernel])
    if not launches or not ns \
            or events != launches * EVENTS_PER_LAUNCH.get(kernel, 1):
        return None
    ops, nbytes = COUNTS[kernel](*calls[kernel])
    bound_s = launches * max(ops / PEAK_BF16_FLOPS, nbytes / HBM_BYTES_PER_S)
    return 100.0 * bound_s / (ns / 1e9)
