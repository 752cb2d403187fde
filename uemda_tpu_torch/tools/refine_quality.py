"""Score refined pseudo labels against target ground truth, per refine mode.

Twin of ``tools/refine_quality.py``::

    python -m uemda_tpu_torch.tools.refine_quality --config-path 2urban \\
        --ckpt-model model.pth --ckpt-proto prototypes.pth \\
        --pseudo-dir log/pseudo_label [--modes none,p,l,s,all] [--device cpu]

The reference's ``analysis_pseudo_labels`` (``pseudo_generation.py:
158-235``) scores mined pseudo labels; this scores the labels a stage-3
step would train on: the stored soft labels through ``label_refine``
(``uemda/gast/alignment.py:194-293``) with the model's ``with_aux`` eval
forward (head logits and feature), the prototypes and the superpixel maps,
for each mode, on one checkpoint. Refinement moves accuracy and coverage
both, so each mode is also scored on its most confident pixels down to the
smallest coverage any mode reaches (``acc_at_matched_coverage``).

``--ckpt-model``: a reference ``.pth`` or the port's ``.npz``;
``--ckpt-proto``: a ``.pth`` tensor or ``.npy``. The model runs in f32, as
the JAX tool's does, on the card unless ``--device cpu``. Prints one JSON
line: {mode: {accuracy, coverage, acc_at_matched_coverage,
acc_delta_vs_none, matched_acc_delta_vs_none}, matched_coverage}.
"""

import argparse
import json

import numpy as np
import torch

from uemda_tpu_torch.alignment.prototypes import init_aligner, label_refine
from uemda_tpu_torch.config import load_config
from uemda_tpu_torch.datasets.augment import normalize
from uemda_tpu_torch.datasets.base import SegDataset, sequential_batches
from uemda_tpu_torch.models.port import load_checkpoint, load_prototypes
from uemda_tpu_torch.ops.pseudo import pseudo_selection
from uemda_tpu_torch.train.loop import (
    batch_to_device,
    build_model,
    max_segments_for,
)
from uemda_tpu_torch.utils.runtime import resolve_device

N_BINS = 512  # confidence histogram resolution for coverage matching


def matched_accuracy(hist_mined, hist_correct, target_kept):
    """Accuracy of the ``target_kept`` most confident pixels, from
    per-confidence-bin counts (bin 0 the lowest): whole bins from the top
    and a fraction of the marginal one, so the take is exactly
    ``target_kept`` even where one bin holds a large mass (fp16 soft labels
    put max-prob ~1.0 in the top bin)."""
    n_bins = len(hist_mined)
    cum_mined = np.cumsum(hist_mined[::-1])
    cum_correct = np.cumsum(hist_correct[::-1])
    i = min(int(np.searchsorted(cum_mined, target_kept)), n_bins - 1)
    prev_mined = float(cum_mined[i - 1]) if i > 0 else 0.0
    prev_correct = float(cum_correct[i - 1]) if i > 0 else 0.0
    bin_mined = float(cum_mined[i]) - prev_mined
    bin_correct = float(cum_correct[i]) - prev_correct
    need = max(target_kept - prev_mined, 0.0)
    matched_correct = prev_correct + (
        bin_correct * need / bin_mined if bin_mined > 0 else 0.0
    )
    return matched_correct / max(float(target_kept), 1.0)


def make_refine_all(model, aligner, cfg, modes, temp: float = 2.0,
                    max_segments: int = None):
    """``refine_all(images_u8, prob, sup)`` -> {mode: (hard, conf)}: the
    eval forward ``with_aux`` of (B, 3, H, W) uint8 images normalized with
    the target split's statistics, then per mode the (B, C, H, W) soft
    label refined by ``label_refine`` on the f32 head logits and feature
    ('none': as stored) and mined by ``pseudo_selection``: (B, H, W) int32
    labels and the soft label's max over its sum (the confidence), all on
    the inputs' device. ``sup``: (B, H, W) superpixel ids."""
    mean, std = cfg.target.mean, cfg.target.std
    if max_segments is None:
        max_segments = max_segments_for(cfg)

    @torch.no_grad()
    def refine_all(images_u8, prob, sup):
        model.eval()
        x = normalize(images_u8, mean, std)
        _, t1, t2, feat = model(x, with_aux=True)
        out = {}
        for m in modes:
            soft = prob.float()
            if m != "none":
                soft = label_refine(aligner, soft, feat.float(),
                                    [t1.float(), t2.float()], sup=sup, mode=m,
                                    temp=temp, max_segments=max_segments)
            hard = pseudo_selection(soft, cfg.cutoff_top, cfg.cutoff_low,
                                    cfg.ignore_label)
            conf = soft.amax(dim=1) / torch.clamp(soft.sum(dim=1), min=1e-12)
            out[m] = (hard, conf)
        return out

    return refine_all


def score(refine_all, ds, ds_gt, modes, batch_size, ignore_label, device):
    """Run ``refine_all`` over ``ds`` (images, soft labels, superpixel maps)
    in order and score each mode against ``ds_gt``'s labels: the report the
    tool prints."""
    kept = {m: 0 for m in modes}
    correct = {m: 0 for m in modes}
    hist_mined = {m: np.zeros(N_BINS, np.int64) for m in modes}
    hist_correct = {m: np.zeros(N_BINS, np.int64) for m in modes}
    total = 0
    for indices, batch in sequential_batches(ds, batch_size):
        gt = np.stack([ds_gt.item(int(i))["label"] for i in indices])
        b = batch_to_device(batch, device)
        out = refine_all(b["image"].permute(0, 3, 1, 2),
                         b["prob"].permute(0, 3, 1, 2), b["sup"])
        valid = gt != ignore_label
        total += int(valid.sum())
        for m in modes:
            h, conf = out[m][0].cpu().numpy(), out[m][1].cpu().numpy()
            mined = (h != ignore_label) & valid
            hit = (h == gt) & mined
            kept[m] += int(mined.sum())
            correct[m] += int(hit.sum())
            bins = np.clip((conf * N_BINS).astype(np.int64), 0, N_BINS - 1)
            hist_mined[m] += np.bincount(bins[mined], minlength=N_BINS)
            hist_correct[m] += np.bincount(bins[hit], minlength=N_BINS)

    target_kept = min(kept.values())
    report = {}
    for m in modes:
        report[m] = {
            "accuracy": correct[m] / max(kept[m], 1),
            "coverage": kept[m] / max(total, 1),
            "acc_at_matched_coverage":
                matched_accuracy(hist_mined[m], hist_correct[m], target_kept),
        }
    report["matched_coverage"] = target_kept / max(total, 1)
    if "none" in report:
        base = report["none"]
        for m in modes:
            report[m]["acc_delta_vs_none"] = (
                report[m]["accuracy"] - base["accuracy"])
            report[m]["matched_acc_delta_vs_none"] = (
                report[m]["acc_at_matched_coverage"]
                - base["acc_at_matched_coverage"])
    return report


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Score refined pseudo labels against target GT.")
    parser.add_argument("--config-path", type=str, required=True)
    parser.add_argument("--ckpt-model", type=str, required=True)
    parser.add_argument("--ckpt-proto", type=str, required=True)
    parser.add_argument("--pseudo-dir", type=str, required=True,
                        help="stored soft labels from pseudo-gen (.npy)")
    parser.add_argument("--modes", type=str, default="none,p,l,s,all")
    parser.add_argument("--refine-temp", type=float, default=2.0)
    parser.add_argument("--batch-size", type=int, default=2)
    parser.add_argument("--device", type=str, default=None,
                        help="default: the card (cuda)")
    args = parser.parse_args(argv)

    device = resolve_device(args.device)
    cfg = load_config(args.config_path)
    model = build_model(cfg, device=device)
    model.load_state_dict(load_checkpoint(args.ckpt_model))
    fc = model.config.inchannels
    aligner = init_aligner(cfg.class_num, fc,
                           prototypes=load_prototypes(args.ckpt_proto),
                           device=device)
    modes = [m.strip() for m in args.modes.split(",") if m.strip()]
    refine_all = make_refine_all(model, aligner, cfg, modes, args.refine_temp,
                                 max_segments_for(cfg))
    ds = SegDataset(cfg.meta, list(cfg.target.image_dir), args.pseudo_dir,
                    label_type="prob", read_sup=True)
    ds_gt = SegDataset(cfg.meta, list(cfg.target.image_dir),
                       list(cfg.target.mask_dir)[0])
    report = score(refine_all, ds, ds_gt, modes, args.batch_size,
                   cfg.ignore_label, device)
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()
