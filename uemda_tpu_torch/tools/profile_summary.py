"""Summary of a ``torch.profiler`` trace, headless.

The port's counterpart of ``tools/profile_summary.py``, which reads JAX's
XProf traces: the trainers' ``--profile-dir DIR`` writes ``DIR/trace.json``
with ``export_chrome_trace`` (``train/loop.py``), and this reads that
chrome trace::

    python -m uemda_tpu_torch.tools.profile_summary DIR_OR_TRACE \\
        [--top 20] [--all-planes]

For each device (an event's ``pid``; its ``tid`` is the stream) it prints
the traced span, each stream's busy time and share, the device-wide busy
share (the union of every stream's intervals) with the idle share beside
it, and the ``--top`` kernels by accumulated time with their call counts.
Device events are those of category ``kernel``, ``gpu_memcpy`` and
``gpu_memset``; ``ts`` and ``dur`` are microseconds, read exactly.
``--all-planes`` adds the host: one plane a process, one line a thread,
over the ``cpu_op``, ``cuda_runtime``, ``user_annotation`` and
``python_function`` events. A trace of a CPU run has no device events, and
the summary says so.
"""

import argparse
import collections
import decimal
import glob
import json
import os

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "user_annotation", "python_function")


def _union_busy(intervals):
    """Total covered time of [start, end) intervals
    (``tools/profile_summary.py:23-33``)."""
    busy, last_end = 0, None
    for s, e in sorted(intervals):
        if last_end is None or s >= last_end:
            busy += e - s
            last_end = e
        elif e > last_end:
            busy += e - last_end
            last_end = e
    return busy


def find_traces(path: str):
    """``path`` itself if it is a file, else every ``*trace.json`` under it
    (sorted)."""
    if os.path.isfile(path):
        return [path]
    return sorted(glob.glob(os.path.join(path, "**", "*trace.json"),
                            recursive=True))


def load_events(path: str):
    """The complete ("X") events of a chrome trace, ``ts`` and ``dur`` as
    integer nanoseconds: the trace's microseconds carry three decimals at
    epoch-sized times, which floats would round to a quarter of a
    nanosecond, enough for two back-to-back kernels to seem to overlap."""
    with open(path) as f:
        trace = json.load(f, parse_float=decimal.Decimal)
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    return [{**e, "ts": int(e["ts"] * 1000), "dur": int(e["dur"] * 1000)}
            for e in events if e.get("ph") == "X" and "dur" in e]


def summarize(events, cats, top_k: int = 20):
    """{plane (``pid``): {'span_us', 'line_busy_us' {``tid``: busy},
    'busy_us' (the union over the lines), 'top' [(name, us)], 'calls'
    Counter}} over the events (of :func:`load_events`) whose category is in
    ``cats``; the sums run over integer nanoseconds."""
    planes = collections.defaultdict(list)
    for e in events:
        if e.get("cat") in cats:
            planes[e["pid"]].append(e)
    out = {}
    for pid, evs in planes.items():
        by_name, calls = collections.Counter(), collections.Counter()
        lines = collections.defaultdict(list)
        for e in evs:
            by_name[e["name"]] += e["dur"]
            calls[e["name"]] += 1
            lines[e["tid"]].append((e["ts"], e["ts"] + e["dur"]))
        every = [iv for ivs in lines.values() for iv in ivs]
        span = max(t for _, t in every) - min(s for s, _ in every)
        out[pid] = {"span_us": span / 1e3,
                    "line_busy_us": {tid: _union_busy(iv) / 1e3
                                     for tid, iv in lines.items()},
                    "busy_us": _union_busy(every) / 1e3,
                    "top": [(n, ns / 1e3)
                            for n, ns in by_name.most_common(top_k)],
                    "calls": calls}
    return out


def _print_plane(kind, pid, s, top, line_word):
    span = s["span_us"]
    print(f"-- {kind} {pid}  span {span / 1e3:.3f} ms")
    for tid, busy in sorted(s["line_busy_us"].items(),
                            key=lambda kv: -kv[1])[:8]:
        frac = busy / span if span else 0.0
        print(f"   {line_word} {str(tid):<26} busy {busy / 1e3:10.3f} ms "
              f"({frac:6.1%})")
    frac = s["busy_us"] / span if span else 0.0
    print(f"   {kind} busy {s['busy_us'] / 1e3:.3f} ms ({frac:.1%}), idle "
          f"share {1 - frac:.3f}")
    print(f"   top {top} by accumulated time:")
    for name, dur in s["top"]:
        print(f"     {dur / 1e3:10.3f} ms x{s['calls'][name]:<6} {name[:90]}")


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Summarize a torch.profiler chrome trace.")
    parser.add_argument("trace", help="the trainers' --profile-dir, or a "
                        "trace .json")
    parser.add_argument("--top", type=int, default=20)
    parser.add_argument("--all-planes", action="store_true",
                        help="add the host's processes and threads")
    args = parser.parse_args(argv)

    paths = find_traces(args.trace)
    if not paths:
        raise SystemExit(f"no trace .json under {args.trace}")
    base = args.trace if os.path.isdir(args.trace) else \
        os.path.dirname(args.trace) or "."
    result = {}
    for path in paths:
        events = load_events(path)
        print(f"== {os.path.relpath(path, base)}")
        devices = summarize(events, DEVICE_CATS, args.top)
        if not devices:
            print("-- no device events (kernel, gpu_memcpy, gpu_memset) in "
                  "this trace: a CPU run, or the profiler saw no device")
        for pid, s in sorted(devices.items(), key=lambda kv: str(kv[0])):
            _print_plane("device", pid, s, args.top, "stream")
        hosts = {}
        if args.all_planes:
            hosts = summarize(events, HOST_CATS, args.top)
            for pid, s in sorted(hosts.items(), key=lambda kv: str(kv[0])):
                _print_plane("host", pid, s, args.top, "thread")
        result[path] = {"devices": devices, "hosts": hosts}
    return result


if __name__ == "__main__":
    main()
