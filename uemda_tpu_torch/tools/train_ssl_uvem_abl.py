"""The UVEM ablation trainer: stage 3 with a sweep every ``GENE_EVERY``
steps and a run dir per swept (m, t, gamma), on the GPU.

Twin of ``tools/train_ssl_uvem_abl.py`` (reference
``tools/train_ssl_uvem-abl.py``; the sweep of ``runs/uemda/
run_abl_uvem.sh``)::

    python -m uemda_tpu_torch.tools.train_ssl_uvem_abl --config-path 2urban \\
        --ckpt-model log/align/Urban_best.pth \\
        --ckpt-proto log/align/prototypes_init.pth --uvem-m 0.2 --uvem-g 4

``train_ssl_uem``'s step (``make_ssl_step``) with the JAX tool's
differences: the run dir is ``<snapshot_dir>/ssl-abl-m{m}-t{t}-g{g}-{lt}``
and the soft labels go to ``<run dir>/pseudo_label``, regenerated every
``GENE_EVERY`` steps (with ``--gen 1``) as ``train_ssl_mix`` runs its
chunks; ``--lt`` has no 'gdp'; there is no ``--ls``/``--bcs`` (the source
loss is CE); the superpixel maps are read only for refine 'all' or 's'
with ``--refine-label 1``; the prototypes come from ``--ckpt-proto``.
``--steps-per-call``, ``--host-crop``, ``--profile-dir`` (the first
chunk's steps 10-15), ``--accum-steps`` and ``--resume`` as ``train_src``.
``--device`` defaults to the card. Not ported yet, and refused:
``--num-devices`` and the multi-process flags (ROADMAP.md queue A8).
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
    maybe_resume,
    run_regen_chunks,
    sweep_streams,
)
from uemda_tpu_torch.train.steps import make_ssl_step
from uemda_tpu_torch.utils.log import str2bool
from uemda_tpu_torch.utils.runtime import resolve_device


def main(argv=None):
    parser = argparse.ArgumentParser(description="UVEM ablation SSL.")
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
    parser.add_argument("--lt", type=str, default="uvem",
                        choices=["uvem", "ups", "ohem", "focal", "ghm", "ce"])
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
    sweep = f"/ssl-abl-m{args.uvem_m}-t{args.uvem_t}-g{args.uvem_g}-{args.lt}"
    cfg = load_config(args.config_path, snapshot_postfix=sweep)
    run_dir = cfg.snapshot_dir
    os.makedirs(run_dir, exist_ok=True)
    main_rank = is_main_process()
    if main_rank:
        snapshot_config(cfg, run_dir)
    logging.basicConfig(level=logging.INFO if main_rank else logging.WARNING,
                        format="%(message)s")
    logger = logging.getLogger("uemda_tpu_torch.train_ssl_uvem_abl")
    logger.info(f"args: {vars(args)}")

    stop_steps = args.steps or cfg.stage3_steps
    model = build_model(cfg, device=device)
    model.load_state_dict(load_checkpoint(args.ckpt_model))
    state = build_state(model, cfg, stop_steps,
                        prototypes=load_prototypes(args.ckpt_proto),
                        balance_temp=args.class_temp,
                        accum_steps=args.accum_steps)
    hp = default_hparams(
        cfg, refine=bool(args.refine_label), refine_mode=args.refine_mode,
        refine_temp=args.refine_temp, target_loss=args.lt,
        balance_target=bool(args.bct), uvem_m=args.uvem_m,
        uvem_t=args.uvem_t, uvem_g=args.uvem_g,
        compute_dtype="bfloat16" if device.type == "cuda" else "float32")
    step_fn = make_ssl_step(model, hp)
    state, start, state_path = maybe_resume(state, run_dir, args.resume,
                                            logger)
    crop = host_crop_of(args, cfg)
    regen, target_stream = sweep_streams(
        model, cfg, os.path.join(run_dir, "pseudo_label"),
        read_sup=hp.refine and hp.refine_mode in ("all", "s"),
        host_crop=crop, fastpath=bool(args.gen_fastpath), logger=logger)
    eval_fn, on_best = make_eval_hook(cfg, run_dir, logger=logger)
    return run_regen_chunks(
        state, step_fn, stop_steps, cfg.gene_every, start, logger, regen,
        lambda skip: make_source_iter(cfg, skip=skip, host_crop=crop)[0],
        target_stream, gen=bool(args.gen), seed=args.seed,
        eval_every=cfg.eval_every, eval_fn=eval_fn, on_best=on_best,
        steps_per_call=args.steps_per_call, profile_dir=args.profile_dir,
        state_path=state_path)


if __name__ == "__main__":
    main()
