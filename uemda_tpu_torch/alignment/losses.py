"""Segmentation losses of stage 1: per-pixel cross entropy and the
multi-head reduction.

The port's copy of ``cross_entropy_per_pixel``, ``cross_entropy_loss`` and
``loss_calc`` (``uemda_tpu/alignment/losses.py:33-75,253-264``; reference
``uemda/gast/balance.py:81-101``, ``utils/tools.py:240-260``). Logits are
NCHW, labels (B, H, W) with ignore_label -1. CE is in f32 and averages over
ALL pixels, ignored ones counting as 0. The class is picked with an exact
``gather``, never a one-hot product in TF32 or bf16. OHEM, focal, GHM, GDP,
UPS and UVEM come with later stages.
"""

from typing import Callable, Sequence

import torch

from uemda_tpu_torch.ops.resize import upsample_logits


def cross_entropy_per_pixel(logits: torch.Tensor, labels: torch.Tensor,
                            ignore_label: int = -1) -> torch.Tensor:
    """(N, C) logits + (N,) labels -> (N,) CE with 0 at ignored pixels."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    valid = labels != ignore_label
    safe = torch.where(valid, labels, torch.zeros_like(labels)).long()
    ce = -torch.gather(logp, -1, safe[:, None])[:, 0]
    return torch.where(valid, ce, torch.zeros_like(ce))


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       ignore_label: int = -1) -> torch.Tensor:
    """``CrossEntropy`` (balance.py:81-101): (B, C, H, W) logits, (B, H, W)
    labels -> the mean over all pixels. (The class-balance pixel weight
    comes with class balancing.)"""
    c = logits.shape[1]
    flat = logits.permute(0, 2, 3, 1).reshape(-1, c)
    return cross_entropy_per_pixel(flat, labels.reshape(-1), ignore_label).mean()


def loss_calc(preds: Sequence[torch.Tensor], label: torch.Tensor,
              loss_fn: Callable) -> torch.Tensor:
    """Multi-head reduction (``utils/tools.py:240-260``): upsample each
    head's logits to the label's resolution (align_corners=True), apply,
    average."""
    hw = tuple(label.shape[-2:])
    total = 0.0
    for p in preds:
        if tuple(p.shape[2:]) != hw:
            p = upsample_logits(p, hw)
        total = total + loss_fn(p, label)
    return total / len(preds)
