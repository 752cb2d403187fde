"""Prototype initialization: one source epoch of exact class means, on the
GPU.

Twin of ``tools/init_prototypes.py`` (reference
``tools/init_prototypes.py:50-119``)::

    python -m uemda_tpu_torch.tools.init_prototypes --config-path 2urban \\
        --ckpt-model log/src/Urban_best.pth --ckpt-proto log/src/prototypes.pth

Loads a stage checkpoint (``.pth`` or the port's ``.npz``), runs the
train-mode feature forward (BatchNorm on batch statistics, its running
statistics left alone) over every full source batch in order (drop_last,
as the reference loader), adds each batch's per-class feature sums and
counts, and saves their ratio, the (C, K) f32 prototypes, as a tensor
``.pth`` (``train_align_uem`` reads it, or a ``.npy``). ``--device``
defaults to the card; ``--device cpu`` runs the plain versions.
"""

import argparse
import logging
import os

import torch

from uemda_tpu_torch.alignment.prototypes import init_avg
from uemda_tpu_torch.config import load_config
from uemda_tpu_torch.datasets.base import SegDataset, sequential_batches
from uemda_tpu_torch.models.port import load_checkpoint
from uemda_tpu_torch.train.loop import (
    batch_to_device,
    build_model,
    build_state,
    default_hparams,
)
from uemda_tpu_torch.train.steps import make_init_proto_step
from uemda_tpu_torch.utils.runtime import resolve_device


def init_prototypes(state, step_fn, dataset, batch_size: int, seed: int,
                    device) -> int:
    """Accumulate every full batch of ``dataset`` in order into
    ``state.aligner``, then set its prototypes to the class means. Returns
    the number of batches."""
    n = 0
    for _, batch in sequential_batches(dataset, batch_size):
        if batch["image"].shape[0] < batch_size:
            continue  # drop_last, like the reference loader
        step_fn(state, batch_to_device(batch, device), seed, index=n)
        n += 1
    state.aligner = init_avg(state.aligner)
    return n


def main(argv=None):
    parser = argparse.ArgumentParser(description="Init prototypes.")
    parser.add_argument("--config-path", type=str, default="2vaihingen")
    parser.add_argument("--ckpt-model", type=str, required=True)
    parser.add_argument("--ckpt-proto", type=str, required=True)
    parser.add_argument("--stage", type=int, default=1)
    parser.add_argument("--seed", type=int, default=2333)
    parser.add_argument("--device", type=str, default=None,
                        help="default: the card (cuda)")
    args = parser.parse_args(argv)

    device = resolve_device(args.device)
    postfix = "/src" if args.stage == 1 else "/align"
    cfg = load_config(args.config_path, snapshot_postfix=postfix)
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    logger = logging.getLogger("uemda_tpu_torch.init_prototypes")
    logger.info(f"args: {vars(args)}")

    model = build_model(cfg, device=device)
    model.load_state_dict(load_checkpoint(args.ckpt_model))
    state = build_state(model, cfg, stop_steps=1)
    hp = default_hparams(
        cfg, compute_dtype="bfloat16" if device.type == "cuda" else "float32")
    ds = SegDataset(cfg.meta, list(cfg.source.image_dir),
                    list(cfg.source.mask_dir)[0])
    n = init_prototypes(state, make_init_proto_step(model, hp), ds,
                        cfg.source.batch_size, args.seed, device)
    logger.info(f"counts = {state.aligner.data_cnt.cpu().numpy().ravel()}")
    os.makedirs(os.path.dirname(os.path.abspath(args.ckpt_proto)),
                exist_ok=True)
    torch.save(state.aligner.prototypes.cpu(), args.ckpt_proto)
    logger.info(f"prototypes saved to {args.ckpt_proto} ({n} batches)")
    return state.aligner


if __name__ == "__main__":
    main()
