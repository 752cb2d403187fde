"""The five-step UemDA and PROCA chains, on the GPU.

Twin of ``tools/run_pipeline.py`` (the reference's
``runs/uemda/run_2vaihingen.sh:3-27`` and ``runs/proca/*.sh``); each step
is a subprocess of the port's tools, glued by ``.pth`` checkpoints under
the config's snapshot directory::

    python -m uemda_tpu_torch.tools.run_pipeline --config-path 2urban

  1. train_src        --align-domain 1          (proca: --align-domain 0)
  2. init_prototypes  --stage 1
  3. train_align_uem  --align-domain 1 --refine-label 1   (proca: train_align)
  4. init_prototypes  --stage 2
  5. train_ssl_uem    --gen 1 --refine-label 1 --lt uvem
                      (proca: --gen 1 --refine-label 0 --lt ce)

``--method`` picks the chain, ``--pretrained`` (a torchvision-style
ImageNet ``.pth``) goes to step 1.
``--steps`` picks a subset, ``--stage-steps`` overrides every training
stage's steps (smoke runs), ``--dry-run`` prints the commands, and
``--device`` goes to every step (``cpu`` runs the plain versions).
``--gate 1`` runs the serving-mode quality gate (``serving_gate``) after
the chain on every stage-best checkpoint that exists, with
``--gate-tolerance`` and ``--gate-class-tolerance``; a breach fails the
run. After the chain, a stage whose best mIoU (``best.json``) falls below
the stage it started from is reported. ``--resume`` (``auto`` or a
path) goes to the three training steps, and so does ``--num-devices``
(each of them then runs as that many processes, one a card;
``tools/run_pipeline.py:82``).
"""

import argparse
import json
import os
import subprocess
import sys

from uemda_tpu_torch.utils.log import str2bool


# the checkout's root, so the steps import this package wherever they start
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def run(cmd, dry: bool) -> None:
    print("+", " ".join(cmd), flush=True)
    if not dry:
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (ROOT, env.get("PYTHONPATH")) if p)
        subprocess.run(cmd, check=True, env=env)


def main(argv=None):
    parser = argparse.ArgumentParser(description="Run the 3-stage pipeline.")
    parser.add_argument("--config-path", type=str, default="2vaihingen")
    parser.add_argument("--steps", type=str, default="1,2,3,4,5",
                        help="comma-separated subset of pipeline steps")
    parser.add_argument("--stage-steps", type=int, default=None,
                        help="override steps for every training stage")
    parser.add_argument("--method", type=str, default="uemda",
                        choices=["uemda", "proca"])
    parser.add_argument("--gen-fastpath", type=str2bool, default=0,
                        help="step 5: run the pseudo-label sweep on the "
                             "folded serving fast path")
    parser.add_argument("--gate", type=str2bool, default=0,
                        help="after the final stage, run the serving-mode "
                             "quality gate on every stage-best checkpoint; "
                             "a mode past tolerance fails the run")
    parser.add_argument("--gate-tolerance", type=float, default=0.005)
    parser.add_argument("--gate-class-tolerance", type=float, default=0.02)
    parser.add_argument("--pretrained", type=str, default=None)
    parser.add_argument("--resume", type=str, default="")
    parser.add_argument("--num-devices", type=int, default=None,
                        help="forwarded to the three training steps")
    parser.add_argument("--device", type=str, default=None,
                        help="forwarded to every step; default: the card")
    parser.add_argument("--dry-run", action="store_true")
    args = parser.parse_args(argv)

    from uemda_tpu_torch.config import load_config

    cfg = load_config(args.config_path)
    log, tset = cfg.snapshot_dir, cfg.target_set
    sel = set(int(s) for s in args.steps.split(","))
    ov = ["--steps", str(args.stage_steps)] if args.stage_steps else []
    if args.resume:
        ov += ["--resume", args.resume]
    dev = ["--device", args.device] if args.device else []
    nd = ["--num-devices", str(args.num_devices)] if args.num_devices else []
    cfg_arg = ["--config-path", args.config_path]

    def tool(name):
        return [sys.executable, "-m", f"uemda_tpu_torch.tools.{name}"]

    proca = args.method == "proca"
    if 1 in sel:
        # proca (runs/proca/*.sh): no CORAL domain alignment in stage 1
        pre = ["--pretrained", args.pretrained] if args.pretrained else []
        run(tool("train_src") + cfg_arg
            + ["--align-domain", "0" if proca else "1"] + pre + ov + nd
            + dev,
            args.dry_run)
    if 2 in sel:
        run(tool("init_prototypes") + cfg_arg
            + ["--stage", "1", "--ckpt-model", f"{log}/src/{tset}_best.pth",
               "--ckpt-proto", f"{log}/src/prototypes_init.pth"] + dev,
            args.dry_run)
    if 3 in sel:
        ckpts = ["--ckpt-model", f"{log}/src/{tset}_best.pth",
                 "--ckpt-proto", f"{log}/src/prototypes_init.pth"]
        if proca:
            run(tool("train_align") + cfg_arg + ckpts + ov + nd + dev,
                args.dry_run)
        else:
            run(tool("train_align_uem") + cfg_arg
                + ["--align-domain", "1", "--refine-label", "1"] + ckpts + ov
                + nd + dev, args.dry_run)
    if 4 in sel:
        run(tool("init_prototypes") + cfg_arg
            + ["--stage", "2", "--ckpt-model", f"{log}/align/{tset}_best.pth",
               "--ckpt-proto", f"{log}/align/prototypes_init.pth"] + dev,
            args.dry_run)
    if 5 in sel:
        # proca: refinement explicitly off (train_ssl_uem defaults
        # --refine-label to 1; the reference baseline runs without it)
        flags = (["--gen", "1", "--refine-label", "0", "--lt", "ce"] if proca
                 else ["--gen", "1", "--refine-label", "1", "--lt", "uvem"])
        if args.gen_fastpath:
            flags += ["--gen-fastpath", "1"]
        run(tool("train_ssl_uem") + cfg_arg + flags
            + ["--ckpt-model", f"{log}/align/{tset}_best.pth",
               "--ckpt-proto", f"{log}/align/prototypes_init.pth"] + ov + nd
            + dev, args.dry_run)
    if args.gate:
        # every stage-best checkpoint that exists: the int8 error depends on
        # the feature distribution, one checkpoint is not evidence
        candidates = [f"{log}/{stage}/{tset}_best.pth"
                      for stage in ("src", "align", "ssl")]
        ckpts = (candidates if args.dry_run
                 else [p for p in candidates if os.path.exists(p)])
        if not ckpts:
            raise SystemExit(f"--gate: no stage-best checkpoints under {log}")
        run(tool("serving_gate") + cfg_arg
            + ["--ckpt-path", ",".join(ckpts),
               "--tolerance", str(args.gate_tolerance),
               "--class-tolerance", str(args.gate_class_tolerance)] + dev,
            args.dry_run)
    if not args.dry_run:
        _warn_on_stage_regression(log)


def _warn_on_stage_regression(log: str, tol: float = 0.02) -> None:
    """Each stage exists to improve on the one it starts from: a later
    stage whose best mIoU ends more than ``tol`` below its predecessor's is
    reported, even when every step exited 0 (``tools/run_pipeline.py:
    177-204``)."""
    chain = ["src", "align", "ssl"]
    best = {}
    for stage in chain:
        path = os.path.join(log, stage, "best.json")
        if os.path.isfile(path):
            with open(path) as f:
                row = json.load(f)
            if row.get("miou") is not None:
                best[stage] = float(row["miou"])
    for prev, cur in zip(chain, chain[1:]):
        if prev in best and cur in best and best[cur] < best[prev] - tol:
            print(f"WARNING: stage '{cur}' best mIoU {best[cur]:.4f} is below "
                  f"its init stage '{prev}' ({best[prev]:.4f} - tol {tol}): "
                  "quality regression; check the target pipeline",
                  flush=True)


if __name__ == "__main__":
    main()
