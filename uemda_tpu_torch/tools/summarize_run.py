"""Summarize a pipeline run's stage run dirs into a markdown record.

Twin of ``tools/summarize_run.py``: reads each stage dir's
``metrics.jsonl`` (the port's training loop writes one row a log step,
``{"step", **metrics}``, and one an evaluation, ``{"step", "miou"}``) and
``best.json`` (``{"miou", "step"}``), and prints the mIoU trajectory as a
table and each stage's best. Pure file parsing. Usage::

    python -m uemda_tpu_torch.tools.summarize_run src=log/src align=log/align
"""

import json
import os
import sys


def read_stage(path):
    """-> (trajectory {step: miou}, best dict or None, last train row)."""
    traj, last_train = {}, None
    mpath = os.path.join(path, "metrics.jsonl")
    if os.path.isfile(mpath):
        with open(mpath) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                row = json.loads(line)
                if "miou" in row:
                    traj[int(row["step"])] = float(row["miou"])
                elif "loss" in row:
                    last_train = row
    best = None
    bpath = os.path.join(path, "best.json")
    if os.path.isfile(bpath):
        with open(bpath) as f:
            best = json.load(f)
    return traj, best, last_train


def main(argv=None):
    stages = []
    for arg in (sys.argv[1:] if argv is None else argv):
        name, _, path = arg.partition("=")
        if not path:
            name, path = os.path.basename(arg.rstrip("/")), arg
        stages.append((name, *read_stage(path)))
    if not stages:
        sys.exit("usage: python -m uemda_tpu_torch.tools.summarize_run "
                 "name=stage_run_dir [...]")

    steps = sorted({s for _, traj, _, _ in stages for s in traj})
    print("| iter | " + " | ".join(n for n, *_ in stages) + " |")
    print("|---" * (len(stages) + 1) + "|")
    for step in steps:
        cells = [f"{traj[step]:.5f}" if step in traj else "—"
                 for _, traj, _, _ in stages]
        print(f"| {step} | " + " | ".join(cells) + " |")
    print()
    for name, traj, best, last_train in stages:
        parts = []
        if best and best.get("miou") is not None:
            parts.append(f"best mIoU {best['miou']:.5f} @ iter "
                         f"{best.get('step')}")
        elif best:
            parts.append("best.json " + json.dumps(best))
        if last_train:
            parts.append("last train row " + json.dumps(last_train))
        if not traj and not best:
            parts.append("no eval rows found")
        print(f"- **{name}**: " + "; ".join(parts))


if __name__ == "__main__":
    main()
