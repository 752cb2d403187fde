"""Adversarial output-space adaptation (AdaptSegNet style), on the GPU.

Twin of ``tools/train_adv.py`` (the working trainer of the reference's
``configs/adv`` method family; discriminator ``uemda/models/
Discriminator.py:4-78``)::

    python -m uemda_tpu_torch.tools.train_adv --config-path 2urban \\
        --lambda-adv 0.001 --d-lr 1e-4

Trains the segmenter on the source loss (``--ls``) plus ``--lambda-adv``
times the fooling term of a patch discriminator on the target's softmax
maps, and the discriminator (Adam at ``--d-lr``) to tell source maps from
target maps, in one step (``train/adversarial.py``). Starts from random
weights, ``--pretrained`` (a torchvision-style ImageNet trunk) or
``--ckpt-model`` (a whole segmenter ``.pth``); ``STAGE1_STEPS`` steps
unless ``--steps``. Evaluates the segmenter every ``EVAL_EVERY`` steps
and at the end, keeping ``<snapshot_dir>/adv/<target>_best.pth``. The
whole state -- segmenter, discriminator and both optimizers -- is
snapshotted to ``<snapshot_dir>/adv/state_curr.pth``, and ``--resume
auto`` goes on from it exactly. ``--accum-steps k``: one segmenter update
per k micro-batches, the discriminator still steps every micro-batch.
``--steps-per-call``, ``--host-crop`` and ``--profile-dir`` as
``train_src``. ``--device`` defaults to the card; ``--device cpu`` runs
the plain versions. Not ported yet, and refused: ``--num-devices`` and the
multi-process flags (ROADMAP.md queue A8).
"""

import argparse
import logging
import os

import torch

from uemda_tpu_torch.config import load_config, snapshot_config
from uemda_tpu_torch.models.port import load_checkpoint
from uemda_tpu_torch.train.adversarial import create_adv_state, make_adv_step
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
from uemda_tpu_torch.utils.runtime import resolve_device


def main(argv=None):
    parser = argparse.ArgumentParser(description="Adversarial DA training.")
    parser.add_argument("--config-path", type=str, default="2vaihingen")
    parser.add_argument("--pretrained", type=str, default=None,
                        help="torchvision-style ImageNet backbone .pth")
    parser.add_argument("--ckpt-model", type=str, default=None,
                        help="a segmenter .pth to start from")
    parser.add_argument("--lambda-adv", type=float, default=0.001)
    parser.add_argument("--d-lr", type=float, default=1e-4)
    parser.add_argument("--ls", type=str, default="CrossEntropy",
                        choices=["CrossEntropy", "OhemCrossEntropy"])
    parser.add_argument("--steps", type=int, default=None)
    parser.add_argument("--seed", type=int, default=2333)
    parser.add_argument("--accum-steps", type=int, default=1,
                        help="gradient accumulation for the segmenter: one "
                             "SGD update per k micro-batches (the "
                             "discriminator still steps every micro-batch)")
    parser.add_argument("--resume", type=str, default="",
                        help="'auto' or a state_curr.pth path (exact "
                             "full-state resume incl. the discriminator)")
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
    cfg = load_config(args.config_path, snapshot_postfix="/adv")
    run_dir = cfg.snapshot_dir
    os.makedirs(run_dir, exist_ok=True)
    main_rank = is_main_process()
    if main_rank:
        snapshot_config(cfg, run_dir)
    logging.basicConfig(level=logging.INFO if main_rank else logging.WARNING,
                        format="%(message)s")
    logger = logging.getLogger("uemda_tpu_torch.train_adv")
    logger.info(f"args: {vars(args)}")

    stop_steps = args.steps or cfg.stage1_steps
    model = build_model(cfg, device=device,
                        generator=torch.Generator().manual_seed(args.seed),
                        pretrained=args.pretrained)
    if args.ckpt_model:
        model.load_state_dict(load_checkpoint(args.ckpt_model))
    seg = build_state(model, cfg, stop_steps, accum_steps=args.accum_steps)
    state = create_adv_state(seg, cfg.class_num, args.d_lr)
    hp = default_hparams(
        cfg, source_loss=source_loss_of(args),
        compute_dtype="bfloat16" if device.type == "cuda" else "float32")
    step_fn = make_adv_step(model, hp, lambda_adv=args.lambda_adv)
    state, start, state_path = maybe_resume(state, run_dir, args.resume,
                                            logger)
    crop = host_crop_of(args, cfg)
    src_iter, _ = make_source_iter(cfg, skip=start, host_crop=crop)
    tgt_iter, _ = make_target_iter(cfg, skip=start, host_crop=crop)
    eval_fn, on_best = make_eval_hook(cfg, run_dir, logger=logger)
    return run_training_loop(state, step_fn, src_iter, tgt_iter, stop_steps,
                             logger, eval_every=cfg.eval_every,
                             eval_fn=eval_fn, on_best=on_best, seed=args.seed,
                             steps_per_call=args.steps_per_call,
                             profile_dir=args.profile_dir,
                             state_path=state_path)


if __name__ == "__main__":
    main()
