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

Then the program's spans (``utils/trace.py``: on while ``--profile-dir``
traces, each a ``user_annotation`` range): per name the count, the total
and the self time (the total less the part its children on the same
thread cover); the device's idle time under each span, every idle gap put
down to the innermost program span open on the thread that issued the
launch ending the gap (none where no span was open, or no launch is
found); and the longest gaps so named. Where ``spans.json`` lies beside
the trace, the program spans are the names it holds, and its table of
the graph replays' phases (device ms a replay) is printed too.
"""

import argparse
import bisect
import collections
import decimal
import glob
import json
import os

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "user_annotation", "python_function")


def _union_runs(intervals):
    """The union of [start, end, ...) intervals as [start, end, the interval
    that opened the run] runs, in time order."""
    runs = []
    for iv in sorted(intervals, key=lambda iv: (iv[0], iv[1])):
        if runs and iv[0] <= runs[-1][1]:
            runs[-1][1] = max(runs[-1][1], iv[1])
        else:
            runs.append([iv[0], iv[1], iv])
    return runs


def _union_busy(intervals):
    """Total covered time of [start, end) intervals
    (``tools/profile_summary.py:23-33``)."""
    return sum(e - s for s, e, _ in _union_runs(intervals))


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


def program_spans(events, names=None):
    """{name: {'n', 'total_us', 'self_us'}} of the ``user_annotation``
    events (those named in ``names``, if given): a span's self time is its
    duration less its children's, the spans of its thread that lie inside
    it."""
    by_tid = collections.defaultdict(list)
    for e in events:
        if e.get("cat") == "user_annotation" \
                and (names is None or e["name"] in names):
            by_tid[(e["pid"], e["tid"])].append(e)
    out = {}
    for evs in by_tid.values():
        evs.sort(key=lambda e: (e["ts"], -e["dur"]))
        stack, child = [], collections.defaultdict(int)
        for i, e in enumerate(evs):
            while stack and evs[stack[-1]]["ts"] + evs[stack[-1]]["dur"] \
                    <= e["ts"]:
                stack.pop()
            if stack:
                child[stack[-1]] += e["dur"]
            stack.append(i)
        for i, e in enumerate(evs):
            s = out.setdefault(e["name"], {"n": 0, "total_us": 0.0,
                                           "self_us": 0.0})
            s["n"] += 1
            s["total_us"] += e["dur"] / 1e3
            s["self_us"] += (e["dur"] - child[i]) / 1e3
    return out


def idle_gaps(events):
    """[(ns, start, the device event ending the gap)] of every device idle
    gap: the union of all devices' and streams' events, as
    :func:`summarize` takes it."""
    runs = _union_runs((e["ts"], e["ts"] + e["dur"], e) for e in events
                       if e.get("cat") in DEVICE_CATS)
    return [(b[0] - a[1], a[1], b[2][2]) for a, b in zip(runs, runs[1:])]


def idle_by_span(events, names=None):
    """{'spans': {name: idle ns}, 'none': idle ns, 'gaps': [(ns, name or
    None)] longest first}: each device idle gap put down to the innermost
    ``user_annotation`` (named in ``names``, if given) open on the thread
    that issued the launch ending it, found by the launch's correlation
    id; None where no span was open or no launch is found."""
    launches = {e["args"]["correlation"]: e for e in events
                if e.get("cat") == "cuda_runtime"
                and "correlation" in e.get("args", {})}
    spans = collections.defaultdict(list)
    for e in events:
        if e.get("cat") == "user_annotation" \
                and (names is None or e["name"] in names):
            spans[(e["pid"], e["tid"])].append(e)
    starts = {}
    for k, evs in spans.items():
        evs.sort(key=lambda e: (e["ts"], -e["dur"]))
        starts[k] = [e["ts"] for e in evs]

    def innermost(launch):
        key = (launch["pid"], launch["tid"])
        evs, t = spans.get(key, []), launch["ts"]
        for i in range(bisect.bisect_right(starts.get(key, []), t) - 1,
                       -1, -1):
            if evs[i]["ts"] + evs[i]["dur"] > t:
                return evs[i]["name"]
        return None

    out = {"spans": collections.defaultdict(int), "none": 0, "gaps": []}
    for ns, _, ev in idle_gaps(events):
        launch = launches.get(ev.get("args", {}).get("correlation"))
        name = innermost(launch) if launch is not None else None
        if name is None:
            out["none"] += ns
        else:
            out["spans"][name] += ns
        out["gaps"].append((ns, name))
    out["spans"] = dict(out["spans"])
    out["gaps"].sort(key=lambda g: -g[0])
    return out


def _print_spans(spans, idle, phases, top):
    print(f"-- program spans: {'name':<24} {'count':>7} {'total ms':>11} "
          f"{'self ms':>11} {'idle ms':>10}")
    for name, s in sorted(spans.items(), key=lambda kv: -kv[1]["total_us"]):
        print(f"   {name:<38} {s['n']:>7} {s['total_us'] / 1e3:11.3f} "
              f"{s['self_us'] / 1e3:11.3f} "
              f"{idle['spans'].get(name, 0) / 1e6:10.3f}")
    whole = sum(idle["spans"].values()) + idle["none"]
    if whole:
        print(f"   device idle {whole / 1e6:.3f} ms, under a program span "
              f"{1 - idle['none'] / whole:.1%}; longest gaps:")
        for ns, name in idle["gaps"][:top]:
            print(f"     {ns / 1e6:10.3f} ms under {name or 'no span'}")
    if phases and phases["phases"]:
        print(f"-- graph replays' phases ({phases['replays']['n']} replays "
              f"read, {phases['replays']['lost']} written over), device ms "
              f"a replay:")
        n = max(phases["replays"]["n"], 1)
        for name, p in phases["phases"].items():
            print(f"   {name:<24} {p['ns'] / n / 1e6:10.3f}")
        print(f"   {'replay':<24} {phases['replays']['ns'] / n / 1e6:10.3f}")


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
        record = os.path.join(os.path.dirname(path), "spans.json")
        phases = names = None
        if os.path.exists(record):
            with open(record) as f:
                phases = json.load(f)
            # its spans are paths (``step/step.prepare``): the last name
            names = {path.rsplit("/", 1)[-1] for path in phases["spans"]}
        spans = program_spans(events, names)
        idle = idle_by_span(events, names)
        if spans or phases:
            _print_spans(spans, idle, phases, args.top)
        result[path] = {"devices": devices, "hosts": hosts, "spans": spans,
                        "idle": idle, "phases": phases}
    return result


if __name__ == "__main__":
    main()
