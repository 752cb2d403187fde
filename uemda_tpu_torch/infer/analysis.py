"""Pseudo-label quality analysis.

The port's copy of ``uemda_tpu/infer/analysis.py`` (reference
``analysis_pseudo_labels``, ``uemda/gast/pseudo_generation.py:158-335``):
the accuracy and coverage of the mined pseudo labels against ground truth,
overall and binned by the soft label's entropy, to tune the CUTOFF and
UVEM thresholds. Mining (:func:`pseudo_selection`) and the entropy
(:func:`pixel_entropy`) run on the device the caller names; the counting
runs on the host.
"""

from typing import Dict

import numpy as np
import torch

from uemda_tpu_torch.datasets.base import SegDataset
from uemda_tpu_torch.datasets.io import read_prob
from uemda_tpu_torch.ops.pseudo import pseudo_selection
from uemda_tpu_torch.ops.uncertainty import pixel_entropy
from uemda_tpu_torch.utils.runtime import resolve_device


def analyze_pseudo_labels(
    label_dir: str,
    pseudo_dir: str,
    meta,
    cutoff_top: float = 0.8,
    cutoff_low: float = 0.6,
    n_bins: int = 10,
    device=None,
) -> Dict:
    """Coverage (mined labelled pixels over labelled pixels), accuracy of
    the mined ones, and per entropy bin (``n_bins`` equal bins of [0, log
    C)) the mined count and accuracy. ``label_dir`` is the split's
    ``ann_dir``, its images under the matching ``img_dir``; ``pseudo_dir``
    holds ``<image filename>.npy`` (or ``.pt``) soft labels. ``device``:
    None is the card."""
    dev = resolve_device(device)
    ds = SegDataset(meta, label_dir.replace("ann_dir", "img_dir"), label_dir)
    total = kept = correct = 0
    bin_edges = np.linspace(0, np.log(meta.num_classes), n_bins + 1)
    bin_cnt = np.zeros(n_bins)
    bin_correct = np.zeros(n_bins)
    for i in range(len(ds)):
        fname = ds.filename(i)
        gt = ds.item(i)["label"]
        prob = torch.from_numpy(read_prob(f"{pseudo_dir}/{fname}")).to(dev)
        prob = prob.float().permute(2, 0, 1)[None]          # (1, C, H, W)
        hard = pseudo_selection(prob, cutoff_top, cutoff_low,
                                meta.ignore_label)[0].cpu().numpy()
        u = pixel_entropy(prob, dim=1)[0].cpu().numpy()
        valid_gt = gt != meta.ignore_label
        mined = (hard != meta.ignore_label) & valid_gt
        total += int(valid_gt.sum())
        kept += int(mined.sum())
        correct += int(((hard == gt) & mined).sum())
        for b in range(n_bins):
            sel = mined & (u >= bin_edges[b]) & (u < bin_edges[b + 1])
            bin_cnt[b] += sel.sum()
            bin_correct[b] += ((hard == gt) & sel).sum()
    return {
        "coverage": kept / max(total, 1),
        "accuracy": correct / max(kept, 1),
        "bin_edges": bin_edges.tolist(),
        "bin_count": bin_cnt.tolist(),
        "bin_accuracy": (bin_correct / np.maximum(bin_cnt, 1)).tolist(),
    }
