"""Aggregate a seed-replicated ablation into mean +/- spread.

Twin of ``tools/ablation_stats.py``: reads every ``<root>/s<seed>_<variant>/
<stage>/metrics.jsonl`` and ``best.json`` (as the port's training loop
writes them) and prints, per variant, each seed's best or final mIoU, the
mean and the spread, and the paired per-seed deltas against a reference
variant (variants of one seed share the data order sample for sample, so
the paired difference removes the data order's part of the noise). Runs
that are missing or have no evaluation yet are flagged. Pure file
parsing. Usage::

    python -m uemda_tpu_torch.tools.ablation_stats --root runs/abl \\
        --seeds 2333,4001,5711 --ref-variant uvem_refine
"""

import argparse
import json
import os

VARIANTS = {  # name -> stage subdir written by the chain
    "uvem_refine": "ssl",
    "uvem_norefine": "ssl",
    "ce": "ssl",
    "ups": "ssl",
    "cutmix": "cutmix",
    "combo": "cutmix",
}


def read_run(path):
    """-> (best_miou or None, final_eval_miou or None, n_evals)."""
    traj = {}
    mpath = os.path.join(path, "metrics.jsonl")
    if os.path.isfile(mpath):
        with open(mpath) as f:
            for line in f:
                line = line.strip()
                if line:
                    row = json.loads(line)
                    if "miou" in row:
                        traj[int(row["step"])] = float(row["miou"])
    best = None
    bpath = os.path.join(path, "best.json")
    if os.path.isfile(bpath):
        with open(bpath) as f:
            best = json.load(f).get("miou")
    final = traj[max(traj)] if traj else None
    return best, final, len(traj)


def fmt(x):
    return f"{x:.5f}" if x is not None else "—"


def mean_spread(vals):
    vals = [v for v in vals if v is not None]
    if not vals:
        return None, None
    m = sum(vals) / len(vals)
    sd = (sum((v - m) ** 2 for v in vals) / len(vals)) ** 0.5
    return m, sd


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--root", required=True)
    p.add_argument("--seeds", default="2333,4001,5711")
    p.add_argument("--ref-variant", default="uvem_refine")
    p.add_argument("--metric", choices=["best", "final"], default="best",
                   help="best = best.json (checkpoint selection, what the "
                   "pipeline ships); final = last eval row")
    args = p.parse_args(argv)
    seeds = [s.strip() for s in args.seeds.split(",") if s.strip()]

    table = {}  # variant -> {seed: (best, final, n)}
    for var, sub in VARIANTS.items():
        for seed in seeds:
            d = os.path.join(args.root, f"s{seed}_{var}", sub)
            if os.path.isdir(d):
                table.setdefault(var, {})[seed] = read_run(d)

    idx = 0 if args.metric == "best" else 1
    print(f"## Seed replication ({args.metric} mIoU), root={args.root}\n")
    print("| variant | " + " | ".join(f"s{s}" for s in seeds)
          + " | mean | sd |")
    print("|---" * (len(seeds) + 3) + "|")
    for var in VARIANTS:
        if var not in table:
            continue
        vals = [table[var].get(s, (None, None, 0))[idx] for s in seeds]
        m, sd = mean_spread(vals)
        print(f"| {var} | " + " | ".join(fmt(v) for v in vals)
              + f" | {fmt(m)} | {fmt(sd)} |")

    ref = args.ref_variant
    if ref in table:
        print(f"\n### Paired per-seed deltas: {ref} − variant "
              f"({args.metric}; + means {ref} wins)\n")
        print("| variant | " + " | ".join(f"s{s}" for s in seeds)
              + " | mean Δ | sd Δ | wins |")
        print("|---" * (len(seeds) + 4) + "|")
        for var in VARIANTS:
            if var == ref or var not in table:
                continue
            deltas = []
            for s in seeds:
                a = table[ref].get(s, (None, None, 0))[idx]
                b = table[var].get(s, (None, None, 0))[idx]
                deltas.append(None if a is None or b is None else a - b)
            m, sd = mean_spread(deltas)
            wins = sum(1 for d in deltas if d is not None and d > 0)
            n = sum(1 for d in deltas if d is not None)
            print(f"| {var} | " + " | ".join(fmt(d) for d in deltas)
                  + f" | {fmt(m)} | {fmt(sd)} | {wins}/{n} |")

    # incomplete runs are flagged, never silently dropped
    for var, runs in table.items():
        for s in seeds:
            if s not in runs:
                print(f"\nWARNING: missing run s{s}_{var}")
            elif runs[s][2] == 0:
                print(f"\nWARNING: s{s}_{var} has no eval rows yet")


if __name__ == "__main__":
    main()
