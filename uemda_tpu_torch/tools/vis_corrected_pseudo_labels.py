"""Corrected-pseudo-label visualization CLI.

Twin of ``tools/vis_corrected_pseudo_labels.py`` (reference root-level
``vis_corrected_pseudo_labels.py``)::

    python -m uemda_tpu_torch.tools.vis_corrected_pseudo_labels \\
        --config-path 2urban --ckpt-path model.pth --ckpt-proto protos.pth \\
        [--refine-mode all] [--out-dir DIR] [--max-images N] [--device cpu]

Runs the target split through the model's ``with_aux`` eval forward
(probabilities, both heads' logits, the feature), refines the
probabilities with ``label_refine`` and writes palette PNGs of the labels
``pseudo_selection`` mines before (``<stem>_raw.png``) and after
(``<stem>_corrected.png``) refinement, then logs how many pixels the
refinement changed. ``label_refine`` is called as the JAX tool calls it,
without ``max_segments``: its default of 2048, under the boundary id of
tiles larger than 724^2 (the NaN of an out-of-range id then makes the
pixel ignore, as in JAX). ``--ckpt-path``: a reference ``.pth`` or the
port's ``.npz``; ``--ckpt-proto``: a ``.pth`` tensor or ``.npy``. f32, on
the card unless ``--device cpu``.
"""

import argparse
import os

import torch

from uemda_tpu_torch.alignment.prototypes import init_aligner, label_refine
from uemda_tpu_torch.config import load_config
from uemda_tpu_torch.datasets.augment import normalize
from uemda_tpu_torch.datasets.base import SegDataset, sequential_batches
from uemda_tpu_torch.models.port import load_checkpoint, load_prototypes
from uemda_tpu_torch.ops.pseudo import pseudo_selection
from uemda_tpu_torch.train.loop import batch_to_device, build_model
from uemda_tpu_torch.utils.log import get_console_file_logger, logging_args
from uemda_tpu_torch.utils.runtime import resolve_device
from uemda_tpu_torch.utils.viz import VisualizeSegmm


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Visualize corrected pseudo labels.")
    parser.add_argument("--config-path", type=str, default="2vaihingen")
    parser.add_argument("--ckpt-path", type=str, required=True)
    parser.add_argument("--ckpt-proto", type=str, required=True)
    parser.add_argument("--refine-mode", type=str, default="all",
                        choices=["s", "p", "n", "l", "all"])
    parser.add_argument("--refine-temp", type=float, default=2.0)
    parser.add_argument("--out-dir", type=str, default=None,
                        help="default <snapshot>/vis_corrected")
    parser.add_argument("--max-images", type=int, default=0,
                        help="limit (0 = whole target train split)")
    parser.add_argument("--device", type=str, default=None,
                        help="default: the card (cuda)")
    args = parser.parse_args(argv)

    device = resolve_device(args.device)
    cfg = load_config(args.config_path)
    out_dir = args.out_dir or os.path.join(cfg.snapshot_dir, "vis_corrected")
    os.makedirs(out_dir, exist_ok=True)
    logger = get_console_file_logger("vis_corrected", cfg.snapshot_dir)
    logging_args(args, logger)

    model = build_model(cfg, device=device)
    model.load_state_dict(load_checkpoint(args.ckpt_path))
    model.eval()
    aligner = init_aligner(
        cfg.class_num, model.config.inchannels,
        ignore_label=cfg.meta.ignore_label,
        prototypes=load_prototypes(args.ckpt_proto), device=device)

    need_sup = args.refine_mode in ("all", "s")
    split = cfg.target
    dataset = SegDataset(cfg.meta, list(split.image_dir), None,
                         label_type="none", read_sup=need_sup)
    ignore = cfg.meta.ignore_label

    viz = VisualizeSegmm(out_dir, cfg.meta.palette)
    done = 0
    changed_px = total_px = 0
    for indices, batch in sequential_batches(dataset, split.batch_size):
        b = batch_to_device(batch, device)
        with torch.no_grad():
            images = normalize(b["image"].permute(0, 3, 1, 2), split.mean,
                               split.std)
            probs, x1, x2, feat = model(images, with_aux=True)
            refined = label_refine(aligner, probs, feat, [x1, x2],
                                   sup=b["sup"] if need_sup else None,
                                   mode=args.refine_mode,
                                   temp=args.refine_temp)
            raw = pseudo_selection(probs, cfg.cutoff_top, cfg.cutoff_low,
                                   ignore).cpu().numpy()
            cor = pseudo_selection(refined, cfg.cutoff_top, cfg.cutoff_low,
                                   ignore).cpu().numpy()
        changed_px += int((raw != cor).sum())
        total_px += raw.size
        for j, idx in enumerate(indices):
            stem = os.path.splitext(dataset.filename(idx))[0]
            viz(raw[j], f"{stem}_raw.png")
            viz(cor[j], f"{stem}_corrected.png")
        done += len(indices)
        if args.max_images and done >= args.max_images:
            break
    logger.info(
        f"{done} images -> {out_dir}; corrected {changed_px}/{total_px} px "
        f"({100.0 * changed_px / max(total_px, 1):.2f}%)")
    return changed_px, total_px


if __name__ == "__main__":
    main()
