"""Segmentation losses: per-pixel cross entropy, the UVEM target loss of
stage 3 and the multi-head reductions.

The port's copy of ``cross_entropy_per_pixel``, ``cross_entropy_loss``,
``uvem_loss``, ``loss_calc`` and ``loss_calc_uvem``
(``uemda_tpu/alignment/losses.py:33-75,217-277``; reference
``uemda/gast/balance.py:81-101,345-457``, ``utils/tools.py:240-260``).
Logits are NCHW, labels (B, H, W) with ignore_label -1, soft labels
(B, C, H, W). CE is in f32 and averages over ALL pixels, ignored ones
counting as 0. The class is picked with an exact ``gather``, never a one-hot
product in TF32 or bf16. A class-balance pixel weight (``alignment/
balance.py``) multiplies the per-pixel terms. OHEM, focal, GHM, GDP and UPS
come with the loss zoo (ROADMAP.md queue A item 8).
"""

from typing import Callable, Optional, Sequence

import torch

from uemda_tpu_torch.ops.resize import upsample_logits
from uemda_tpu_torch.ops.uncertainty import pixel_entropy, uvem_weight


def cross_entropy_per_pixel(logits: torch.Tensor, labels: torch.Tensor,
                            ignore_label: int = -1) -> torch.Tensor:
    """(N, C) logits + (N,) labels -> (N,) CE with 0 at ignored pixels."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    valid = labels != ignore_label
    safe = torch.where(valid, labels, torch.zeros_like(labels)).long()
    ce = -torch.gather(logp, -1, safe[:, None])[:, 0]
    return torch.where(valid, ce, torch.zeros_like(ce))


def _flat(logits: torch.Tensor, labels: torch.Tensor):
    c = logits.shape[1]
    return logits.permute(0, 2, 3, 1).reshape(-1, c), labels.reshape(-1)


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       ignore_label: int = -1,
                       pixel_weight: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """``CrossEntropy`` (balance.py:81-101): (B, C, H, W) logits, (B, H, W)
    labels -> the mean over all pixels, each CE times its ``pixel_weight``
    ((B*H*W,) in (b, h, w) order) when given."""
    flat, lab = _flat(logits, labels)
    ce = cross_entropy_per_pixel(flat, lab, ignore_label)
    if pixel_weight is not None:
        ce = ce * pixel_weight.reshape(-1)
    return ce.mean()


def uvem_loss(logits: torch.Tensor, labels: torch.Tensor,
              label_soft: Optional[torch.Tensor] = None, m: float = 0.2,
              threshold: float = 0.7, gamma: float = 4.0,
              ignore_label: int = -1,
              pixel_weight: Optional[torch.Tensor] = None,
              paste_mask: Optional[torch.Tensor] = None,
              w: Optional[torch.Tensor] = None,
              u: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``UVEMLoss`` (balance.py:345-423): the uncertainty gate ``u <=
    threshold`` and the parabola weight ``w`` on the per-pixel CE, summed
    and divided by the count of trained, labelled pixels.

    The entropy comes from ``label_soft`` (B, C, H, W), as in the JAX
    signature, or, as the stage-3 step passes them, from the ``w`` and
    ``u`` (B, H, W) that K8 (``ops/mine.py``) mined once for both heads;
    either way it carries no gradient. ``paste_mask`` (the combo mix step):
    pixels of pasted clean source supervision train at weight 1, ungated,
    and count in the denominator only when trained."""
    flat, lab = _flat(logits, labels)
    if label_soft is not None:
        u = pixel_entropy(label_soft.detach(), dim=1)
        w = uvem_weight(u, m, threshold, gamma)
    elif w is None or u is None:
        raise ValueError("uvem_loss: pass label_soft, or both w and u")
    u, w = u.detach().reshape(-1), w.detach().reshape(-1)
    ce = cross_entropy_per_pixel(flat, lab, ignore_label)
    trained = u <= threshold
    if paste_mask is not None:
        pm = paste_mask.reshape(-1)
        w = torch.where(pm, torch.ones_like(w), w)
        trained = trained | pm
    ce = torch.where(trained, ce, torch.zeros_like(ce))
    if pixel_weight is not None:
        w = w * pixel_weight.reshape(-1)
    valid_cnt = (trained & (lab != ignore_label)).sum()
    return (w * ce).sum() / (valid_cnt + 1e-7)


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


def loss_calc_uvem(preds: Sequence[torch.Tensor], label: torch.Tensor,
                   label_soft: torch.Tensor, loss_fn: Callable
                   ) -> torch.Tensor:
    """(balance.py:437-457) :func:`loss_calc` for the soft-label losses:
    ``loss_fn(logits, label, label_soft)`` per head."""
    return loss_calc(preds, label, lambda p, lb: loss_fn(p, lb, label_soft))
