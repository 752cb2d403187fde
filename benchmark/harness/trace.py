"""A short profiled stretch and what is read from its trace.

``Stretch`` runs ``torch.profiler`` (CPU and CUDA activities) over a few
steps or requests after the measured window, with the device drained at
both ends, so the stretch's wall time is the host's clock between them.
Its chrome trace goes to a temporary file (under ``TMPDIR``) that is read
and deleted at once.

:func:`load_events` and :func:`union_busy` are frozen copies of the port's
``tools/profile_summary.py`` readers: times as integer nanoseconds (the
trace's epoch microseconds carry three decimals, which floats round enough
to make back-to-back kernels overlap), and a stream's busy time as the
union of its events, since on the H100 some kernels of one stream overlap.
"""

import decimal
import json
import os
import tempfile
import time
from typing import Dict, List, Optional, Sequence, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime")


def union_busy(intervals) -> int:
    """Total covered time of [start, end) intervals."""
    busy, last_end = 0, None
    for s, e in sorted(intervals):
        if last_end is None or s >= last_end:
            busy += e - s
            last_end = e
        elif e > last_end:
            busy += e - last_end
            last_end = e
    return busy


def load_events(path: str) -> List[dict]:
    """The complete ("X") events of a chrome trace, ``ts`` and ``dur`` in
    integer nanoseconds."""
    with open(path) as f:
        trace = json.load(f, parse_float=decimal.Decimal)
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    return [{**e, "ts": int(e["ts"] * 1000), "dur": int(e["dur"] * 1000)}
            for e in events if e.get("ph") == "X" and "dur" in e]


class Stretch:
    """``start()`` and ``stop()`` around the profiled work; then
    :attr:`events`, :attr:`wall_ns` and :meth:`summary`."""

    def __init__(self):
        self.events: List[dict] = []
        self.wall_ns = 0
        self._prof = None

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        self._prof = profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA])
        self._prof.start()
        self._t0 = time.perf_counter_ns()

    def stop(self) -> None:
        import torch

        torch.cuda.synchronize()
        self.wall_ns = time.perf_counter_ns() - self._t0
        self._prof.stop()
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            self.events = load_events(path)
        finally:
            os.remove(path)
        self._prof = None

    def summary(self) -> dict:
        return summarize(self.events, self.wall_ns)


def summarize(events: Sequence[dict], wall_ns: int, top: int = 10) -> dict:
    """Device busy time (the union over every stream), kernel time by
    name, and the longest device idle gaps, each named by the longest host
    event that overlaps it."""
    dev = [e for e in events if e.get("cat") in DEVICE_CATS]
    host = [e for e in events if e.get("cat") in HOST_CATS]
    if not dev:
        return {"busy_ns": 0, "wall_ns": wall_ns, "by_name": {},
                "calls": {}, "gaps": []}
    ivs = sorted((e["ts"], e["ts"] + e["dur"]) for e in dev)
    by_name: Dict[str, int] = {}
    calls: Dict[str, int] = {}
    for e in dev:
        by_name[e["name"]] = by_name.get(e["name"], 0) + e["dur"]
        calls[e["name"]] = calls.get(e["name"], 0) + 1
    gaps, end = [], None
    for s, e in ivs:
        if end is not None and s > end:
            gaps.append((s - end, end, s))
        end = e if end is None else max(end, e)
    gaps.sort(reverse=True)
    named = []
    for length, a, b in gaps[:top]:
        best, over = "host: no traced operation", 0
        for h in host:
            ov = min(b, h["ts"] + h["dur"]) - max(a, h["ts"])
            if ov > over:
                best, over = f"host: {h['name']}", ov
        named.append((best, length))
    return {"busy_ns": union_busy(ivs), "wall_ns": wall_ns,
            "by_name": by_name, "calls": calls, "gaps": named}


def kernel_ns(summary: dict, patterns: Sequence[str]) -> Tuple[int, int]:
    """(summed device ns, events) of the kernels whose name holds any of
    ``patterns``."""
    ns = n = 0
    for name, t in summary["by_name"].items():
        if any(p in name for p in patterns):
            ns += t
            n += summary["calls"][name]
    return ns, n


def breakdown(summary: dict, top: int = 10) -> Optional[dict]:
    if not summary["by_name"]:
        return None
    ops = sorted(summary["by_name"].items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[n[:200], t / 1e9] for n, t in ops],
            "idle_gaps": [[n[:200], t / 1e9] for n, t in
                          summary["gaps"][:top]]}
