#!/usr/bin/env python3
"""Run one cell of the benchmark of ``uemda_tpu_torch`` once, on the card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

From the root of a checkout. The cell, its configuration and its traffic
mix are found by name through ``BENCHMARK.json`` (``harness/spec.py``);
the mix's driver (``drivers/<driver>.py``) makes the inputs and weights
from the seed, sets up and warms the program, measures for ``--seconds``
seconds and checks what the timed path produced against the plain
reference (``reference/``), holding each number compared to the cell's
limit (``limits/<cell>.json``). With ``--trace 1`` a short stretch after
the window runs under the profiler and the cell's per-layer metrics
(``metrics/<name>.py``) are reported in place of its end-to-end ones.

Every line but the last goes to standard error, ending with each number
compared beside its limit; the last line of standard output is one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics``, ``device``,
with ``--trace 1`` ``breakdown``, and last ``checks``. Without a CUDA
device, with fewer cards than the cell asks for, or with JAX or the JAX
package loaded once the window has closed, it prints no result and exits
non-zero.
"""

import time

T_START = time.perf_counter()
T_CPU = time.process_time()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


# Python's bytecode of every module the run imports (PyTorch's, the
# program's, the harness's), kept inside the checkout: where the
# interpreter is told not to write bytecode beside the sources, each run
# would compile PyTorch's modules again, some seconds of set-up that vary
# with the host's load. Only a checkout's first run writes it.
PYCACHE = os.path.join(ROOT, "build", "pycache")


def keep_bytecode() -> None:
    """Read and write compiled modules under :data:`PYCACHE`."""
    sys.pycache_prefix = PYCACHE
    sys.dont_write_bytecode = False


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def result_line(spec, cell: str, result: dict, trace: bool, limits,
                device) -> dict:
    """The result line's object. ``device`` is the card's record, or None
    for a run off the card, whose numbers are never written under the
    metrics' names."""
    from benchmark.harness.judge import verdict

    metrics = {}
    if device is not None and trace:
        for m in spec.per_layer(cell):
            val = spec.reader(m["name"])(result)
            if val is not None:
                metrics[m["name"]] = {"value": val, "unit": m["unit"]}
    elif device is not None:
        values = dict(result["e2e"], setup_s=result["setup_s"])
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in spec.end_to_end(cell)}
    ok, rows = verdict(result["readings"], limits)
    ok = ok and math.isfinite(result["last_loss"]) \
        if "last_loss" in result else ok
    ok = ok and all(math.isfinite(m["value"]) for m in metrics.values())
    line = {"correct": bool(ok), "attempted": result["attempted"],
            "failed": result["failed"], "metrics": metrics}
    if device is not None:
        line["device"] = dict(device,
                              memory_peak_bytes=result["memory_peak_bytes"])
        st = result.get("stretch")
        if trace and st:
            from benchmark.harness.trace import breakdown

            line["device"]["busy_s"] = st["busy_ns"] / 1e9
            line["device"]["window_s"] = st["wall_ns"] / 1e9
            bd = breakdown(st)
            if bd:
                line["breakdown"] = bd
    line["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in rows}
    return line


def main(argv=None) -> int:
    keep_bytecode()
    args = parse(argv)
    from benchmark.harness.spec import Spec, driver

    spec = Spec()
    cell = spec.cell(args.workload)
    spec.check_cell(args.workload)
    from benchmark.harness import device as card

    card.require_cards(cell["chips"])
    from uemda_tpu_torch import kernels

    from benchmark.drivers.common import Context

    traffic = spec.traffic(cell["traffic"])
    limits = spec.limits(args.workload)
    ctx = Context(cell=args.workload, config=spec.config(cell["config"]),
                  traffic=traffic, seed=args.seed,
                  seconds=args.seconds, trace=bool(args.trace),
                  t_start=T_START)
    ctx.mark("imports")
    kernels.build()   # every kernel library the checkout lacks, at once
    ctx.mark("kernel build")
    card.init_cards(cell["chips"])
    ctx.mark("cuda context")
    ctx.log(f"card before: {card.smi()}")
    result = driver(traffic["driver"]).run(ctx)
    found = card.forbidden_loaded()
    if found:
        print(f"forbidden modules loaded: {', '.join(found)}", file=sys.stderr)
        return 3
    line = result_line(spec, args.workload, result, bool(args.trace),
                       limits["numbers"], card.device_record(cell["chips"]))
    ctx.log(f"card after the window: {ctx.card_after}")
    ctx.log(f"setup_s {result['setup_s']:.3f}, window_s "
            f"{result['window_s']:.3f}, attempted {result['attempted']}, "
            f"e2e {json.dumps(result['e2e'])}, "
            f"layer {json.dumps(result['layer'])}")
    ctx.log("set-up by part (s: wall, of it the process's CPU): " + ", ".join(
        f"{part} {wall - prev:.3f} ({cpu - prev_cpu:.3f})"
        for (part, wall, cpu), (_, prev, prev_cpu)
        in zip(ctx.marks, [("start", 0.0, T_CPU)] + ctx.marks)))
    if "stretch_launches" in result:
        from benchmark.harness.readers import launch_check

        ctx.log(f"stretch launches and trace events by kernel: "
                f"{launch_check(result)} over {result['stretch_work']} "
                f"steps or requests")
    for name, c in line["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
