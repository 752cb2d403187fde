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
``--device`` defaults to the card; ``--device cpu`` runs the plain
versions. The reference's OHEM (``--ls``), class balance (``--bcs``) and
``--pretrained`` come with later slices.
"""

import argparse
import logging
import os

import torch

from uemda_tpu_torch.config import load_config
from uemda_tpu_torch.tools.eval import str2bool
from uemda_tpu_torch.train.loop import (
    build_model,
    build_state,
    default_hparams,
    make_eval_hook,
    make_source_iter,
    make_target_iter,
    run_training_loop,
)
from uemda_tpu_torch.train.steps import make_src_step
from uemda_tpu_torch.utils.runtime import resolve_device


def main(argv=None):
    parser = argparse.ArgumentParser(description="Train on source (stage 1).")
    parser.add_argument("--config-path", type=str, default="2vaihingen")
    parser.add_argument("--align-domain", type=str2bool, default=0)
    parser.add_argument("--steps", type=int, default=None,
                        help="override STAGE1_STEPS")
    parser.add_argument("--seed", type=int, default=2333)
    parser.add_argument("--device", type=str, default=None,
                        help="default: the card (cuda)")
    args = parser.parse_args(argv)

    device = resolve_device(args.device)
    cfg = load_config(args.config_path, snapshot_postfix="/src")
    run_dir = cfg.snapshot_dir
    os.makedirs(run_dir, exist_ok=True)
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    logger = logging.getLogger("uemda_tpu_torch.train_src")
    logger.info(f"args: {vars(args)}")

    hp = default_hparams(
        cfg, align_domain=bool(args.align_domain),
        compute_dtype="bfloat16" if device.type == "cuda" else "float32")
    stop_steps = args.steps or cfg.stage1_steps
    model = build_model(cfg, device=device,
                        generator=torch.Generator().manual_seed(args.seed))
    step_fn = make_src_step(model, hp)
    state = build_state(model, cfg, stop_steps)
    src_iter, _ = make_source_iter(cfg)
    tgt_iter = make_target_iter(cfg)[0] if hp.align_domain else None
    eval_fn, on_best = make_eval_hook(cfg, run_dir, logger=logger)
    return run_training_loop(state, step_fn, src_iter, tgt_iter, stop_steps,
                             logger, eval_every=cfg.eval_every,
                             eval_fn=eval_fn, on_best=on_best, seed=args.seed)


if __name__ == "__main__":
    main()
