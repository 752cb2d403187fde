"""Per-class adaptive-threshold pseudo-label mining.

The port's copy of ``uemda_tpu/ops/pseudo.py`` (reference
``uemda/gast/pseudo_generation.py:24-93``): per (sample, class) the
threshold is max(cutoff_top * the class's largest probability, cutoff_low);
:func:`pseudo_selection` keeps a pixel's class when exactly one class lies
strictly above its threshold, else ignore. Probabilities are (B, C, H, W);
labels come back (B, H, W) int32. Exact: comparisons on f32 values.
"""

import torch


def class_thresholds(probs: torch.Tensor, cutoff_top: float,
                     cutoff_low: float) -> torch.Tensor:
    """(B, C, 1, 1) f32 max(cutoff_top * class max, cutoff_low): the same
    operations for the plain selection and for K8 (``ops/mine.py``)."""
    class_max = probs.amax(dim=(2, 3), keepdim=True)
    return torch.clamp(class_max * cutoff_top, min=cutoff_low)


def pseudo_selection(probs: torch.Tensor, cutoff_top: float = 0.8,
                     cutoff_low: float = 0.6, ignore_label: int = -1
                     ) -> torch.Tensor:
    """(B, C, H, W) probs -> (B, H, W) int32: the one class strictly above
    its threshold (``pseudo_generation.py:83``), ignore where none or
    several are."""
    probs = probs.float()
    over = probs > class_thresholds(probs, cutoff_top, cutoff_low)
    label = over.to(torch.uint8).argmax(dim=1).to(torch.int32)
    one = over.sum(dim=1) == 1
    return torch.where(one, label, torch.full_like(label, ignore_label))


def pseudo_selection_threshold(probs: torch.Tensor, cutoff_top: float = 0.8,
                               cutoff_low: float = 0.6,
                               ignore_label: int = -1) -> torch.Tensor:
    """The reference's alternative rule ``pseudo_selection1``
    (pseudo_generation.py:24-56): the argmax class, ignore where its
    probability falls below that class's threshold."""
    probs = probs.float()
    thresh = class_thresholds(probs, cutoff_top, cutoff_low)
    top, label = probs.max(dim=1)
    pix_thresh = torch.gather(thresh.expand_as(probs), 1, label[:, None])[:, 0]
    label = label.to(torch.int32)
    return torch.where(top < pix_thresh, torch.full_like(label, ignore_label),
                       label)
