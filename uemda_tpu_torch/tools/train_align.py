"""PROCA's stage 2: prototype contrastive alignment without refinement, on
the GPU.

Twin of ``tools/train_align.py`` (reference ``tools/train_align.py:
55-191``)::

    python -m uemda_tpu_torch.tools.train_align --config-path 2urban \\
        --ckpt-model log/src/Urban_best.pth \\
        --ckpt-proto log/src/prototypes_init.pth

Loads the stage-1 model and the prototypes (``.pth`` or ``.npy``); each
step EMA-updates the prototypes from the source batch, takes the target's
label as the stride-16 arg-max of the averaged head softmax where its max
reaches ``--conf-thresh``, and adds PCL on both domains
(``train/steps.py``'s ``AlignSimpleStep``); no superpixel maps. Evaluates
every ``EVAL_EVERY`` steps and at the end, and keeps
``<snapshot_dir>/align/<target>_best.pth``, ``prototypes_best.pth`` and
``best.json``. ``--ls``, ``--bcs``, ``--class-temp``, ``--accum-steps``,
``--steps-per-call``, ``--host-crop``, ``--profile-dir`` and ``--resume``
as ``train_src``. ``--device`` defaults to the card; ``--device cpu`` runs
the plain versions.
"""

import argparse
import logging
import os

from uemda_tpu_torch.config import load_config, snapshot_config
from uemda_tpu_torch.models.port import load_checkpoint, load_prototypes
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
from uemda_tpu_torch.train.steps import make_align_simple_step
from uemda_tpu_torch.utils.log import str2bool
from uemda_tpu_torch.utils.runtime import resolve_device


def main(argv=None):
    parser = argparse.ArgumentParser(description="PCL align (no refine).")
    parser.add_argument("--config-path", type=str, default="2vaihingen")
    parser.add_argument("--ckpt-model", type=str, required=True)
    parser.add_argument("--ckpt-proto", type=str, required=True)
    parser.add_argument("--align-domain", type=str2bool, default=0)
    parser.add_argument("--ls", type=str, default="CrossEntropy",
                        choices=["CrossEntropy", "OhemCrossEntropy"])
    parser.add_argument("--bcs", type=str2bool, default=0)
    parser.add_argument("--class-temp", type=float, default=2.0)
    parser.add_argument("--pcl-temp", type=float, default=8.0)
    parser.add_argument("--conf-thresh", type=float, default=0.9)
    parser.add_argument("--steps", type=int, default=None)
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
    cfg = load_config(args.config_path, snapshot_postfix="/align")
    run_dir = cfg.snapshot_dir
    os.makedirs(run_dir, exist_ok=True)
    main_rank = is_main_process()
    if main_rank:
        snapshot_config(cfg, run_dir)
    logging.basicConfig(level=logging.INFO if main_rank else logging.WARNING,
                        format="%(message)s")
    logger = logging.getLogger("uemda_tpu_torch.train_align")
    logger.info(f"args: {vars(args)}")

    stop_steps = args.steps or cfg.stage2_steps
    model = build_model(cfg, device=device)
    model.load_state_dict(load_checkpoint(args.ckpt_model))
    state = build_state(model, cfg, stop_steps,
                        prototypes=load_prototypes(args.ckpt_proto),
                        balance_temp=args.class_temp,
                        accum_steps=args.accum_steps)
    hp = default_hparams(
        cfg, align_domain=bool(args.align_domain),
        source_loss=source_loss_of(args), balance_source=bool(args.bcs),
        pcl_temp=args.pcl_temp,
        compute_dtype="bfloat16" if device.type == "cuda" else "float32")
    step_fn = make_align_simple_step(model, hp, conf_thresh=args.conf_thresh)
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
