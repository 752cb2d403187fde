"""Stage 1: supervised source training + optional CORAL domain alignment,
on the GPU.

Twin of ``tools/train_src.py`` (reference ``tools/train_src.py:43-172``)::

    python -m uemda_tpu_torch.tools.train_src --config-path 2urban \\
        --align-domain 1 --steps 4000

Same schedule semantics (the poly horizon is 1.5 x the stage steps, warm-up
the first stage/20 steps) and cadence: log every 50 steps, evaluate every
``EVAL_EVERY`` steps and at the end with ``infer/evaluate.py``, keep
``<snapshot_dir>/src/<target>_best.pth`` (the model's state dict under the
reference's key names, which ``uemda_tpu_torch.tools.eval`` loads).
``--ls OhemCrossEntropy`` trains the heads with OHEM instead of CE, ``--bcs
1`` weights the source loss by the EMA class balance (temperature
``--class-temp``), ``--pretrained`` loads a torchvision-style ImageNet
``.pth`` into the trunk and ``--accum-steps k`` makes one update of the
mean gradient of k micro-batches (the schedule's horizon is then the
number of updates). ``--steps-per-call K`` runs K steps a call (on the
card, replays of a CUDA graph of the step), ``--host-crop 1`` crops the
samples on the host before their upload and ``--profile-dir`` traces steps
10-15 and turns the tracer on for the run (``spans.json`` beside the
trace: its spans, counters and the graph replays' phase times). The whole train state is snapshotted to
``<snapshot_dir>/src/state_curr.pth`` at every evaluation and at the end,
beside ``metrics.jsonl`` and ``best.json``; ``--resume auto`` (or a
snapshot's path) goes on from it exactly: the same state, draws and
batches as a run that was never stopped. ``--device`` defaults to the
card; ``--device cpu`` runs the plain versions.
"""

import argparse
import logging
import os

import torch

from uemda_tpu_torch.config import load_config, snapshot_config
from uemda_tpu_torch.utils.log import str2bool
from uemda_tpu_torch.parallel.multihost import is_main_process, launch
from uemda_tpu_torch.train.loop import (
    add_loop_flags,
    add_parallel_flags,
    build_model,
    build_state,
    default_hparams,
    host_crop_of,
    make_eval_hook,
    make_source_iter,
    make_target_iter,
    maybe_resume,
    run_training_loop,
    source_loss_of,
)
from uemda_tpu_torch.train.steps import make_src_step
from uemda_tpu_torch.utils.runtime import resolve_device


def main(argv=None):
    parser = argparse.ArgumentParser(description="Train on source (stage 1).")
    parser.add_argument("--config-path", type=str, default="2vaihingen")
    parser.add_argument("--align-domain", type=str2bool, default=0)
    parser.add_argument("--ls", type=str, default="CrossEntropy",
                        choices=["CrossEntropy", "OhemCrossEntropy"])
    parser.add_argument("--bcs", type=str2bool, default=0,
                        help="class balance for source")
    parser.add_argument("--class-temp", type=float, default=2.0)
    parser.add_argument("--pretrained", type=str, default=None,
                        help="torchvision-style ImageNet backbone .pth")
    parser.add_argument("--steps", type=int, default=None,
                        help="override STAGE1_STEPS")
    parser.add_argument("--seed", type=int, default=2333)
    parser.add_argument("--accum-steps", type=int, default=1,
                        help="gradient accumulation: one SGD update per k "
                             "micro-batches (effective batch k x batch)")
    parser.add_argument("--resume", type=str, default="",
                        help="'auto' or a state_curr.pth path (exact "
                             "full-state resume)")
    parser.add_argument("--device", type=str, default=None,
                        help="default: the card (cuda)")
    add_parallel_flags(parser)
    add_loop_flags(parser)
    args = parser.parse_args(argv)
    return launch(_run, args)


def _run(args):
    """The trainer in this process: one device, or one rank of the data-
    parallel group ``launch`` made (``parallel/multihost.py``)."""

    device = resolve_device(args.device)
    cfg = load_config(args.config_path, snapshot_postfix="/src")
    run_dir = cfg.snapshot_dir
    os.makedirs(run_dir, exist_ok=True)
    main_rank = is_main_process()
    if main_rank:
        snapshot_config(cfg, run_dir)
    logging.basicConfig(level=logging.INFO if main_rank else logging.WARNING,
                        format="%(message)s")
    logger = logging.getLogger("uemda_tpu_torch.train_src")
    logger.info(f"args: {vars(args)}")

    hp = default_hparams(
        cfg, align_domain=bool(args.align_domain),
        source_loss=source_loss_of(args), balance_source=bool(args.bcs),
        compute_dtype="bfloat16" if device.type == "cuda" else "float32")
    stop_steps = args.steps or cfg.stage1_steps
    model = build_model(cfg, device=device,
                        generator=torch.Generator().manual_seed(args.seed),
                        pretrained=args.pretrained)
    step_fn = make_src_step(model, hp)
    state = build_state(model, cfg, stop_steps, balance_temp=args.class_temp,
                        accum_steps=args.accum_steps)
    state, start, state_path = maybe_resume(state, run_dir, args.resume,
                                            logger)
    crop = host_crop_of(args, cfg)
    src_iter, _ = make_source_iter(cfg, skip=start, host_crop=crop)
    tgt_iter = (make_target_iter(cfg, skip=start, host_crop=crop)[0]
                if hp.align_domain else None)
    eval_fn, on_best = make_eval_hook(cfg, run_dir, logger=logger)
    return run_training_loop(state, step_fn, src_iter, tgt_iter, stop_steps,
                             logger, eval_every=cfg.eval_every,
                             eval_fn=eval_fn, on_best=on_best, seed=args.seed,
                             steps_per_call=args.steps_per_call,
                             profile_dir=args.profile_dir,
                             state_path=state_path)


if __name__ == "__main__":
    main()
