"""Self-training with CutMix / ClassMix / DACS domain mixing, on the GPU.

Twin of ``tools/train_ssl_mix.py`` (reference ``tools/train_ssl_mix.py:
54-207``)::

    python -m uemda_tpu_torch.tools.train_ssl_mix --config-path 2urban \\
        --ckpt-model log/align/Urban_best.pth --mix classmix --lt uvem \\
        --refine-label 1 --ckpt-proto log/align/prototypes_init.pth

Loads the stage-2 model. The target's soft pseudo labels come from a sweep
(slide + 8-view TTA, ``--gen-fastpath 1`` on the folded fast path) into
``<snapshot_dir>/../pseudo_label``, regenerated every ``GENE_EVERY`` steps
with ``--gen 1``; each step mines hard labels from them and pastes source
content into the target batch (``--mix``) before the two forwards
(``train/steps.py``'s ``MixStep``). ``--lt legacy`` is the reference's CE
on both mixed batches (OHEM with ``--ls OhemCrossEntropy``); any stage-3
``--lt`` (uvem, ups, ohem, focal, ghm, gdp, ce), with ``--refine-label``
(``--ckpt-proto``, the prototypes) or without, is the combo: online
refinement and the stage-3 target loss on the mixed batch. Runs in
``GENE_EVERY`` chunks as the JAX tool: each chunk's loop counts, logs,
evaluates and snapshots from its own start, with the seed ``--seed`` plus
the chunk's start. ``--steps-per-call``, ``--host-crop``, ``--profile-dir``
(the first chunk's steps 10-15), ``--accum-steps`` and ``--resume`` as
``train_src``; a resume past the first chunk with ``--gen 1`` regenerates
before its first live chunk, as the JAX tool does. ``--device`` defaults
to the card. Not ported yet, and refused: ``--num-devices`` and the
multi-process flags (ROADMAP.md queue A8).
"""

import argparse
import logging
import os

import torch

from uemda_tpu_torch.config import load_config, snapshot_config
from uemda_tpu_torch.datasets.base import SegDataset, infinite_batches
from uemda_tpu_torch.datasets.prefetch import prefetch
from uemda_tpu_torch.infer.pseudo_gen import generate_pseudo_labels
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
    process_shard,
    maybe_resume,
    run_regen_chunks,
    run_training_loop,
    source_loss_of,
)
from uemda_tpu_torch.train.steps import make_mix_step
from uemda_tpu_torch.utils.log import str2bool
from uemda_tpu_torch.utils.runtime import resolve_device

LOSS_CHOICES = ["legacy", "uvem", "ups", "ohem", "focal", "ghm", "gdp", "ce"]


def main(argv=None):
    parser = argparse.ArgumentParser(description="SSL with domain mixing.")
    parser.add_argument("--config-path", type=str, default="2vaihingen")
    parser.add_argument("--ckpt-model", type=str, required=True)
    parser.add_argument("--gen", type=str2bool, default=1)
    parser.add_argument("--gen-fastpath", type=str2bool, default=0,
                        help="run the pseudo-label sweep on the folded "
                             "serving fast path (exact math)")
    parser.add_argument("--mix", type=str, default="cutmix",
                        choices=["cutmix", "classmix", "dacs"])
    parser.add_argument("--ls", type=str, default="CrossEntropy",
                        choices=["CrossEntropy", "OhemCrossEntropy"])
    parser.add_argument("--bcs", type=str2bool, default=0)
    parser.add_argument("--class-temp", type=float, default=2.0)
    parser.add_argument("--lt", type=str, default="legacy",
                        choices=LOSS_CHOICES,
                        help="target loss on the mixed batch: 'legacy' is "
                             "the reference's CE on the mined labels; the "
                             "others the stage-3 loss (the combo)")
    parser.add_argument("--refine-label", type=str2bool, default=0,
                        help="refine the stored soft labels online before "
                             "mining and mixing (needs --ckpt-proto)")
    parser.add_argument("--refine-mode", type=str, default="all",
                        choices=["s", "p", "n", "l", "all"])
    parser.add_argument("--refine-temp", type=float, default=2.0)
    parser.add_argument("--ckpt-proto", type=str, default=None,
                        help="stage-2 prototypes (.pth or .npy; required "
                             "with --refine-label 1)")
    parser.add_argument("--bct", type=str2bool, default=0)
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
    if args.refine_label and not args.ckpt_proto:
        parser.error("--refine-label 1 requires --ckpt-proto")

    device = resolve_device(args.device)
    cfg = load_config(args.config_path, snapshot_postfix=f"/{args.mix}")
    run_dir = cfg.snapshot_dir
    os.makedirs(run_dir, exist_ok=True)
    main_rank = is_main_process()
    if main_rank:
        snapshot_config(cfg, run_dir)
    logging.basicConfig(level=logging.INFO if main_rank else logging.WARNING,
                        format="%(message)s")
    logger = logging.getLogger("uemda_tpu_torch.train_ssl_mix")
    logger.info(f"args: {vars(args)}")
    on_card = device.type == "cuda"
    combo = args.lt != "legacy" or bool(args.refine_label)

    stop_steps = args.steps or cfg.stage3_steps
    model = build_model(cfg, device=device)
    model.load_state_dict(load_checkpoint(args.ckpt_model))
    prototypes = load_prototypes(args.ckpt_proto) if args.ckpt_proto else None
    state = build_state(model, cfg, stop_steps, prototypes=prototypes,
                        balance_temp=args.class_temp,
                        accum_steps=args.accum_steps)
    hp = default_hparams(
        cfg, source_loss=source_loss_of(args), balance_source=bool(args.bcs),
        refine=bool(args.refine_label),
        refine_mode=args.refine_mode, refine_temp=args.refine_temp,
        target_loss=args.lt if args.lt != "legacy" else "ce",
        balance_target=bool(args.bct), uvem_m=args.uvem_m,
        uvem_t=args.uvem_t, uvem_g=args.uvem_g,
        compute_dtype="bfloat16" if on_card else "float32")
    step_fn = make_mix_step(model, hp, mix=args.mix, combo=combo)
    state, start, state_path = maybe_resume(state, run_dir, args.resume,
                                            logger)
    crop = host_crop_of(args, cfg)
    pseudo_dir = os.path.join(run_dir, "..", "pseudo_label")
    gen_ds = SegDataset(cfg.meta, list(cfg.target.image_dir), None,
                        label_type="none")
    need_sup = hp.refine and hp.refine_mode in ("all", "s")

    # the sweep and its stream as ``train.loop.sweep_streams``'s, on this
    # module's own names (the mix tests replace them)
    def regen():
        """A sweep of the target split by the current model (an eval-mode
        copy: the training model and its captured step are untouched)."""
        generate_pseudo_labels(
            model, gen_ds, cfg.target.mean, cfg.target.std,
            out_dir=pseudo_dir, tile=cfg.crop, tta=True,
            batch_size=min(4, cfg.target.batch_size),
            cutoff_top=cfg.cutoff_top, cutoff_low=cfg.cutoff_low,
            keep_in_memory=False,
            compute_dtype=torch.bfloat16 if on_card else torch.float32,
            device=device, logger=logger, fastpath=bool(args.gen_fastpath))

    def target_stream(skip):
        ds = SegDataset(cfg.meta, list(cfg.target.image_dir), pseudo_dir,
                        label_type="prob", read_sup=need_sup)
        return prefetch(infinite_batches(
            ds, cfg.target.batch_size, seed=1, skip_batches=skip,
            process_shard=process_shard(cfg.target.batch_size),
            host_crop=crop))

    eval_fn, on_best = make_eval_hook(cfg, run_dir, logger=logger)
    return run_regen_chunks(
        state, step_fn, stop_steps, cfg.gene_every, start, logger, regen,
        lambda skip: make_source_iter(cfg, skip=skip, host_crop=crop)[0],
        target_stream, gen=bool(args.gen), seed=args.seed,
        run_loop=run_training_loop, eval_every=cfg.eval_every,
        eval_fn=eval_fn, on_best=on_best,
        steps_per_call=args.steps_per_call, profile_dir=args.profile_dir,
        state_path=state_path)


if __name__ == "__main__":
    main()
