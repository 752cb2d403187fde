"""Stage 3: self-training with uncertainty-based valuable example mining, on
the GPU.

Twin of ``tools/train_ssl_uem.py`` (reference ``tools/train_ssl_uem.py:
69-266``)::

    python -m uemda_tpu_torch.tools.train_ssl_uem --config-path 2urban \\
        --ckpt-model log/align/Urban_best.pth \\
        --ckpt-proto log/align/prototypes_init.pth --gen 1 --lt uvem

Loads the stage-2 model and the prototypes (``.pth`` or ``.npy``). With
``--gen 1`` it first sweeps the target split (slide + 8-view TTA, in the
compute dtype; ``--gen-fastpath 1`` on the folded fast path) into
``<snapshot_dir>/../pseudo_label/<image>.npy`` and palette PNGs of the mined
labels into ``pseudo_label_color``; then it trains on the source labels and
on those soft labels, refined online (``--refine-mode``; the superpixel view
reads the ``_sup_shrink`` maps), with the target loss of ``--lt``: UVEM
(``ours|uvem``), UPS, OHEM, focal, GHM, GDP, plain CE or none. Evaluates
every ``EVAL_EVERY`` steps and at the end, and keeps
``<snapshot_dir>/ssl/<target>_best.pth``,
``prototypes_best.pth`` and ``best.json``. ``--steps-per-call``,
``--host-crop`` (which also crops the stored soft labels on the host),
``--profile-dir`` and ``--resume`` as ``train_src``; a resumed run skips
the sweep (the interrupted run's soft labels are on disk, and the same
stage-2 model would give them again). ``--ls`` and ``--accum-steps`` as
``train_src``. ``--device`` defaults to the card; ``--device cpu`` runs
the plain versions. Not ported yet, and refused: ``--num-devices`` and
the multi-process flags (ROADMAP.md queue A8).
"""

import argparse
import logging
import os

import torch

from uemda_tpu_torch.config import load_config, snapshot_config
from uemda_tpu_torch.datasets.base import SegDataset
from uemda_tpu_torch.infer.pseudo_gen import generate_pseudo_labels
from uemda_tpu_torch.models.port import load_checkpoint, load_prototypes
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
from uemda_tpu_torch.train.steps import make_ssl_step
from uemda_tpu_torch.utils.runtime import resolve_device

LOSS_CHOICES = ["ours", "uvem", "ohem", "focal", "ghm", "gdp", "ups", "none",
                "ce"]


def main(argv=None):
    parser = argparse.ArgumentParser(description="Self-training (stage 3).")
    parser.add_argument("--config-path", type=str, default="2vaihingen")
    parser.add_argument("--ckpt-model", type=str, required=True)
    parser.add_argument("--ckpt-proto", type=str, required=True)
    parser.add_argument("--gen", type=str2bool, default=1)
    parser.add_argument("--gen-fastpath", type=str2bool, default=0,
                        help="run the pseudo-label sweep on the folded "
                             "serving fast path (exact math)")
    parser.add_argument("--refine-label", type=str2bool, default=1)
    parser.add_argument("--refine-mode", type=str, default="all",
                        choices=["s", "p", "n", "l", "all"])
    parser.add_argument("--refine-temp", type=float, default=2.0)
    parser.add_argument("--ls", type=str, default="CrossEntropy",
                        choices=["CrossEntropy", "OhemCrossEntropy"])
    parser.add_argument("--bcs", type=str2bool, default=0)
    parser.add_argument("--lt", type=str, default="uvem", choices=LOSS_CHOICES)
    parser.add_argument("--bct", type=str2bool, default=0)
    parser.add_argument("--class-temp", type=float, default=2.0)
    parser.add_argument("--uvem-m", type=float, default=0.2)
    parser.add_argument("--uvem-t", type=float, default=0.7)
    parser.add_argument("--uvem-g", type=float, default=4)
    parser.add_argument("--steps", type=int, default=None)
    parser.add_argument("--seed", type=int, default=2333)
    parser.add_argument("--accum-steps", type=int, default=1)
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
    cfg = load_config(args.config_path, snapshot_postfix="/ssl")
    run_dir = cfg.snapshot_dir
    os.makedirs(run_dir, exist_ok=True)
    main_rank = is_main_process()
    if main_rank:
        snapshot_config(cfg, run_dir)
    logging.basicConfig(level=logging.INFO if main_rank else logging.WARNING,
                        format="%(message)s")
    logger = logging.getLogger("uemda_tpu_torch.train_ssl_uem")
    logger.info(f"args: {vars(args)}")
    on_card = device.type == "cuda"

    stop_steps = args.steps or cfg.stage3_steps
    model = build_model(cfg, device=device)
    model.load_state_dict(load_checkpoint(args.ckpt_model))
    state = build_state(model, cfg, stop_steps,
                        prototypes=load_prototypes(args.ckpt_proto),
                        balance_temp=args.class_temp,
                        accum_steps=args.accum_steps)
    state, start, state_path = maybe_resume(state, run_dir, args.resume,
                                            logger)

    # the pseudo-label sweep (train_ssl_uem.py:177-189), skipped on resume
    pseudo_dir = os.path.join(run_dir, "..", "pseudo_label")
    if args.gen and start == 0:
        logger.info("###### generating pseudo labels ######")
        gen_ds = SegDataset(cfg.meta, list(cfg.target.image_dir), None,
                            label_type="none")
        generate_pseudo_labels(
            model, gen_ds, cfg.target.mean, cfg.target.std, out_dir=pseudo_dir,
            tile=cfg.crop, tta=True, batch_size=min(4, cfg.target.batch_size),
            cutoff_top=cfg.cutoff_top, cutoff_low=cfg.cutoff_low,
            color_dir=pseudo_dir + "_color", keep_in_memory=False,
            compute_dtype=torch.bfloat16 if on_card else torch.float32,
            device=device, logger=logger,
            fastpath=bool(args.gen_fastpath))

    hp = default_hparams(
        cfg, source_loss=source_loss_of(args), balance_source=bool(args.bcs),
        refine=bool(args.refine_label),
        refine_mode=args.refine_mode, refine_temp=args.refine_temp,
        target_loss={"ours": "uvem"}.get(args.lt, args.lt),
        balance_target=bool(args.bct), uvem_m=args.uvem_m,
        uvem_t=args.uvem_t, uvem_g=args.uvem_g,
        compute_dtype="bfloat16" if on_card else "float32")
    step_fn = make_ssl_step(model, hp)
    crop = host_crop_of(args, cfg)
    src_iter, _ = make_source_iter(cfg, skip=start, host_crop=crop)
    need_sup = hp.refine and hp.refine_mode in ("all", "s")
    tgt_iter, _ = make_target_iter(cfg, read_sup=need_sup, prob_dir=pseudo_dir,
                                   skip=start, host_crop=crop)
    eval_fn, on_best = make_eval_hook(cfg, run_dir, logger=logger)
    return run_training_loop(state, step_fn, src_iter, tgt_iter, stop_steps,
                             logger, eval_every=cfg.eval_every,
                             eval_fn=eval_fn, on_best=on_best, seed=args.seed,
                             steps_per_call=args.steps_per_call,
                             profile_dir=args.profile_dir,
                             state_path=state_path)


if __name__ == "__main__":
    main()
