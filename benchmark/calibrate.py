#!/usr/bin/env python3
"""The readings a cell's correctness limits are set from, on the card.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,3 \\
        [--seconds 2]

For each seed, in one process: a run of the cell's driver with a short
window, then the numbers compared for the program (the lower readings),
for the control (the reference computed in float8 in the program's place)
and, for a training cell, for the half-batch fault (the reference's step
on the first half of each batch, the mean taken over it), for the
reference rounded to bf16 where the program rounds (a witness: it reads as
a sound program does) and the worst leaves. One JSON line a seed, then
the largest program reading and the smallest of each other kind.
``limits/<cell>.json`` records what they gave. ``--dtype float32`` runs
the program in f32 without TF32 in place of the configuration's compute
dtype: a second witness.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--dtype", default=None,
                   help="the program's compute dtype in place of the "
                   "configuration's (a look at a reading's cause)")
    args = p.parse_args(argv)
    from benchmark.drivers.common import Context, free_device
    from benchmark.harness import device as card
    from benchmark.harness.spec import Spec, driver

    spec = Spec()
    cell = spec.cell(args.workload)
    card.require_cards(cell["chips"])
    if args.dtype == "float32":
        import torch

        # the look at a reading's cause: the program in full f32
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    traffic = spec.traffic(cell["traffic"])
    conf = spec.config(cell["config"])
    if args.dtype:
        conf["compute_dtype"] = args.dtype
    lower, upper = {}, {}
    for seed in (int(s) for s in args.seeds.split(",")):
        ctx = Context(cell=args.workload, config=conf, traffic=traffic,
                      seed=seed, seconds=args.seconds,
                      trace=False, t_start=time.perf_counter(),
                      calibrate=True)
        res = driver(traffic["driver"]).run(ctx)
        row = {"seed": seed, "program": res["readings"], **res["extra"],
               "setup_s": res["setup_s"], "e2e": res["e2e"]}
        print(json.dumps(row), flush=True)
        for k, v in res["readings"].items():
            lower[k] = max(lower.get(k, 0.0), v)
        for kind, vals in res["extra"].items():
            if kind == "leaves":
                continue
            for k, v in vals.items():
                upper.setdefault(kind, {})
                upper[kind][k] = min(upper[kind].get(k, float("inf")), v)
        del res
        free_device()
    print(json.dumps({"lower": lower, "upper": upper}), flush=True)
    found = card.forbidden_loaded()
    if found:
        print(f"forbidden modules loaded: {found}", file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main())
