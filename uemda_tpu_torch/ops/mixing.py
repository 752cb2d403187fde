"""ClassMix and CutMix domain mixing on the device.

The port's copy of ``uemda_tpu/ops/mixing.py:18-129`` (reference
``uemda/utils/classmix.py:17-53``, ``uemda/utils/cutmix.py:15-53``), with
the draws split from the math: :func:`draw_mix` makes a step's draws on
the host -- ClassMix's class subset as a (C,) 0/1 mask, CutMix's
Beta(alpha, alpha) ``lam`` and box centre ``(cx, cy)``, the in-batch
permutation -- and the mixers take them as tensors, so a captured step
reads each step's draws from device memory. Images are (B, 3, H, W),
labels (B, H, W), soft labels (B, C, H, W).

With ``probs_s``/``probs_t`` a mixer also returns the pasted soft map and
the (B, H, W) bool paste mask as its 5th and 6th elements (the combo
step's: pasted pixels carry clean source supervision).
"""

import dataclasses
from typing import Optional, Tuple

import torch

from uemda_tpu_torch.datasets.augment import to_device
from uemda_tpu_torch.ops.labels import one_hot_ignore
from uemda_tpu_torch.parallel import mesh


@dataclasses.dataclass
class MixDraws:
    """One step's mix draws. ClassMix: ``selected`` (C,) f32 0/1; CutMix:
    ``lam``, ``cx``, ``cy`` f32 scalars; ``cutmix_inbatch`` also ``perm``
    (B,) int64. Unused fields are None."""

    selected: Optional[torch.Tensor] = None
    lam: Optional[torch.Tensor] = None
    cx: Optional[torch.Tensor] = None
    cy: Optional[torch.Tensor] = None
    perm: Optional[torch.Tensor] = None

    def to(self, device) -> "MixDraws":
        return MixDraws(**{
            f.name: None if getattr(self, f.name) is None
            else to_device(getattr(self, f.name), device)
            for f in dataclasses.fields(self)})


def draw_mix(generator: torch.Generator, mix: str, hw, class_num: int = 7,
             ratio: float = 0.5, alpha: float = 1.0,
             batch: Optional[int] = None) -> MixDraws:
    """The draws of ``mix`` ("classmix" or "dacs": the first
    ``int(class_num * ratio)`` classes of a permutation; "cutmix": a box
    of area ``1 - lam`` of the ``hw`` image, ``lam`` ~ Beta(alpha, alpha),
    its centre uniform over the image; with ``batch``, also the in-batch
    permutation of ``cutmix_inbatch``) from a CPU generator."""
    if mix in ("classmix", "dacs"):
        perm = torch.randperm(class_num, generator=generator)
        selected = torch.zeros(class_num, dtype=torch.float32)
        selected[perm[:int(class_num * ratio)]] = 1.0
        return MixDraws(selected=selected)
    if mix != "cutmix":
        raise ValueError(f"unknown mix {mix!r}")
    perm = (torch.randperm(batch, generator=generator) if batch is not None
            else None)
    # Beta(a, a) as X / (X + Y) of two Gamma(a) draws
    g = torch._standard_gamma(torch.full((2,), float(alpha),
                                         dtype=torch.float64),
                              generator=generator)
    lam = (g[0] / (g[0] + g[1])).float()
    h, w = hw
    cx = torch.rand((), generator=generator) * w
    cy = torch.rand((), generator=generator) * h
    return MixDraws(lam=lam, cx=cx, cy=cy, perm=perm)


def box_mask(hw: Tuple[int, int], lam: torch.Tensor, cx: torch.Tensor,
             cy: torch.Tensor) -> torch.Tensor:
    """The (H, W) bool CutMix box of ``lam`` centred at (cx, cy)
    (cutmix.py:17-28): edges rounded half to even and clipped to the
    image, all in f32 on the device."""
    h, w = hw
    one = torch.ones_like(lam)
    bw = w * torch.sqrt(one - lam)
    bh = h * torch.sqrt(one - lam)
    x0 = torch.round(torch.clamp(cx - bw / 2, 0, w))
    x1 = torch.round(torch.clamp(cx + bw / 2, 0, w))
    y0 = torch.round(torch.clamp(cy - bh / 2, 0, h))
    y1 = torch.round(torch.clamp(cy + bh / 2, 0, h))
    ys = torch.arange(h, device=lam.device, dtype=lam.dtype)[:, None]
    xs = torch.arange(w, device=lam.device, dtype=lam.dtype)[None, :]
    return (ys >= y0) & (ys < y1) & (xs >= x0) & (xs < x1)


def classmix_mask(selected: torch.Tensor, targets_s: torch.Tensor,
                  class_num: int, ignore_label: int = -1) -> torch.Tensor:
    """(B, H, W) bool: the source pixels whose class is in the subset
    (never an ignored one)."""
    oh = one_hot_ignore(targets_s, class_num, ignore_label)
    return (oh * selected).sum(-1) > 0


def paste(mask: torch.Tensor, data_s, targets_s, data_t, targets_t,
          probs_s=None, probs_t=None):
    """Source pixels pasted into the target where the (B, H, W) or (H, W)
    bool ``mask`` holds; returns what the mixers return."""
    mask = mask.expand(targets_t.shape)
    new_data_t = torch.where(mask[:, None], data_s, data_t)
    new_targets_t = torch.where(mask, targets_s, targets_t)
    if probs_s is None:
        return data_s, targets_s, new_data_t, new_targets_t
    new_probs_t = torch.where(mask[:, None], probs_s, probs_t)
    return data_s, targets_s, new_data_t, new_targets_t, new_probs_t, mask


def classmix_paste(selected: torch.Tensor, data_s, targets_s, data_t,
                   targets_t, class_num: int, ignore_label: int = -1,
                   probs_s=None, probs_t=None):
    """ClassMix on a given (C,) 0/1 class subset (classmix.py:42-51)."""
    return paste(classmix_mask(selected, targets_s, class_num, ignore_label),
                 data_s, targets_s, data_t, targets_t, probs_s, probs_t)


def classmix(draws: MixDraws, data_s, targets_s, data_t, targets_t,
             class_num: int = 7, ignore_label: int = -1, probs_s=None,
             probs_t=None):
    """Paste the pixels of the drawn half of the classes from source into
    target; the subset is batch-wide, like the reference's one randperm a
    call."""
    return classmix_paste(draws.selected, data_s, targets_s, data_t,
                          targets_t, class_num, ignore_label, probs_s,
                          probs_t)


def cutmix(draws: MixDraws, data_s, targets_s, data_t, targets_t,
           probs_s=None, probs_t=None):
    """The drawn source box pasted into every target (cutmix.py:15-31)."""
    mask = box_mask(tuple(targets_t.shape[-2:]), draws.lam, draws.cx,
                    draws.cy)
    return paste(mask, data_s, targets_s, data_t, targets_t, probs_s,
                 probs_t)


def cutmix_inbatch(draws: MixDraws, data: torch.Tensor,
                   targets: torch.Tensor):
    """The in-batch variant (cutmix.py:33-53): the box pasted from the
    batch permuted by ``draws.perm``."""
    mask = box_mask(tuple(targets.shape[-2:]), draws.lam, draws.cx, draws.cy)
    # ``perm`` permutes the global batch under data parallelism
    src = mesh.shard_rows(mesh.gather_rows(data)[draws.perm])
    src_t = mesh.shard_rows(mesh.gather_rows(targets)[draws.perm])
    _, _, new_data, new_targets = paste(mask, src, src_t, data, targets)
    return new_data, new_targets
