"""Segmentation losses: the loss zoo of the three stages and the multi-head
reductions.

The port's copy of ``uemda_tpu/alignment/losses.py`` (reference
``uemda/gast/balance.py:81-457``, ``utils/tools.py:240-260``): per-pixel
cross entropy, CE, OHEM, focal, GHM and GDP with their histogram state,
UPS, UVEM, ``loss_calc`` and ``loss_calc_uvem``. Logits are NCHW, labels
(B, H, W) with ignore_label -1, soft labels (B, C, H, W). CE is in f32 and
averages over ALL pixels, ignored ones counting as 0. The class is picked
with an exact ``gather``, never a one-hot product in TF32 or bf16. A
class-balance pixel weight (``alignment/balance.py``) multiplies the
per-pixel terms.

Under data parallelism (``parallel/mesh.py``) every mean, count and
histogram is over the global batch: the numerators, the counts and the
GHM/GDP bins are summed over the ranks, and OHEM sorts the gathered CEs of
every rank. At world size 1 each is the plain expression.

Every loss can be captured in a CUDA graph: no ``.item()``, no host branch
on data, no op that sizes its output from the data. OHEM's k is a device
tensor that masks a full sort; the GHM/GDP histograms count by comparing
against fixed f32 edges, and their bucket indices bucketize against
them.
"""

import dataclasses
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from uemda_tpu_torch.ops.resize import upsample_logits
from uemda_tpu_torch.parallel import mesh
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
    return mesh.gmean(ce)


def ohem_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                       ignore_label: int = -1, thresh: float = 0.7,
                       pixel_weight: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """``OhemCrossEntropy`` (balance.py:104-133) in the JAX package's
    fixed-shape form (``losses.py:78-97``): the mean of the k largest
    (weighted) per-pixel CEs, k = max(#valid // 5, #(ce > -log thresh)),
    as a masked sum over the descending sort."""
    flat, lab = _flat(logits, labels)
    ce = cross_entropy_per_pixel(flat, lab, ignore_label)
    if pixel_weight is not None:
        ce = ce * pixel_weight.reshape(-1)
    loss_thresh = float(-np.log(np.float32(thresh)))   # an f32 value
    n_min = torch.div(mesh.gsum((lab != ignore_label).sum()), 5,
                      rounding_mode="floor")
    k = torch.maximum(n_min, mesh.gsum((ce > loss_thresh).sum()))
    if mesh.world_size() == 1:
        desc = torch.sort(ce, descending=True).values
        keep = torch.arange(ce.shape[0], device=ce.device) < k
        return (desc * keep).sum() / torch.clamp_min(k, 1).float()
    # the sort runs over the global batch's pixels: every rank sorts the
    # gathered CEs, marks the k largest and sums its own marked ones
    every = mesh.gather_rows(ce.detach())
    order = torch.sort(every, descending=True).indices
    top = torch.arange(every.shape[0], device=ce.device) < k
    keep = torch.zeros_like(top).scatter_(0, order, top)
    keep = keep[mesh.rows(ce.shape[0])]
    return mesh.gsum((ce * keep).sum()) / torch.clamp_min(k, 1).float()


def focal_loss(logits: torch.Tensor, labels: torch.Tensor, gamma: float = 2.0,
               ignore_label: int = -1) -> torch.Tensor:
    """``FocalLoss`` (balance.py:136-158): (1 - p_y)^gamma CE, the mean
    over all pixels."""
    flat, lab = _flat(logits, labels)
    ce = cross_entropy_per_pixel(flat, lab, ignore_label)
    pt = torch.exp(-ce)
    return mesh.gmean((1.0 - pt) ** gamma * ce)


@dataclasses.dataclass
class GHMState:
    """The GHM/GDP gradient-density histogram (``losses.py:100-108``), an
    EMA over steps; ``acc_sum`` (bins,) f32 is the state a step writes."""
    acc_sum: torch.Tensor
    momentum: float = 0.99
    bins: int = 30

    def replace(self, **changes) -> "GHMState":
        return dataclasses.replace(self, **changes)


def init_ghm(bins: int = 30, momentum: float = 0.99, device=None) -> GHMState:
    return GHMState(torch.zeros(bins, dtype=torch.float32, device=device),
                    momentum, bins)


def ghm_edges(bins: int, device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The two f32 edge sets of ``_ghm_gradient_and_bins`` as the jitted
    JAX step computes them: the histogram's ``linspace(0, 1, bins + 1)``
    and the bucket index's ``arange(bins) / bins ++ [1 + 1e-3]``. Under
    ``jit`` XLA turns both divisions by ``bins`` into a product with the
    f32 reciprocal, so both are ``i * f32(1 / bins)``; the sets differ in
    their last edge (1.0 against f32(1.001))."""
    recip = float(np.float32(1.0) / np.float32(bins))   # f32, exact
    inner = torch.arange(bins, dtype=torch.float32, device=device) * recip
    hist = torch.cat([inner, torch.ones(1, device=device)])
    search = torch.cat([inner, torch.full((1,), float(np.float32(1.0 + 1e-3)),
                                          device=device)])
    return hist, search


def ghm_bins(g: torch.Tensor, bins: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(N,) gradient norms, -1 at ignored pixels -> ``jnp.histogram(g,
    bins, range=(0, 1))``'s f32 counts (bins,) and ``searchsorted(edges, g,
    side='left')``'s bucket index (N,) int64, both against the exact edges
    of :func:`ghm_edges`. The histogram is right-open but for g == 1.0,
    which lands in the last bin; values outside [0, 1] are dropped."""
    hist_edges, search_edges = ghm_edges(bins, g.device)
    # bin j holds #(g >= e_j) - #(g >= e_j+1), the last one's upper count
    # #(g > 1): comparisons and sums, where an index_add_ of one per pixel
    # serialises millions of atomics on 30 addresses (7.3 ms a flagship
    # step on the H100)
    at_least = (g[None, :] >= hist_edges[:bins, None]).sum(dim=1)
    above = (g > hist_edges[bins]).sum()
    counts = at_least - torch.cat([at_least[1:], above[None]])
    return counts.float(), torch.bucketize(g, search_edges, right=False)


def _ghm_gradient_and_bins(flat: torch.Tensor, lab: torch.Tensor,
                           ignore_label: int, bins: int):
    """Shared GHM/GDP plumbing (balance.py:173-194): g = |p_y - 1| in f32
    (-1 at ignored pixels), its histogram and bucket indices."""
    probs = torch.softmax(flat.float(), dim=-1)
    valid = lab != ignore_label
    safe = torch.where(valid, lab, torch.zeros_like(lab)).long()
    g = torch.abs(torch.gather(probs, -1, safe[:, None])[:, 0] - 1.0)
    g = torch.where(valid, g, torch.full_like(g, -1.0)).detach()
    hist, inds = ghm_bins(g, bins)
    return g, mesh.gsum(hist), inds


def _ema(state: GHMState, hist: torch.Tensor) -> torch.Tensor:
    if state.momentum > 0:
        return state.momentum * state.acc_sum + (1 - state.momentum) * hist
    return hist


def _bin_lookup(table: torch.Tensor, inds: torch.Tensor, bins: int
                ) -> torch.Tensor:
    """table[inds - 1] where 0 < inds <= bins, else 0."""
    in_range = (inds > 0) & (inds <= bins)
    val = table[torch.clamp(inds - 1, 0, bins - 1)]
    return torch.where(in_range, val, torch.zeros_like(val))


def ghm_loss(logits: torch.Tensor, labels: torch.Tensor, state: GHMState,
             ignore_label: int = -1) -> Tuple[torch.Tensor, GHMState]:
    """``GHMLoss`` (balance.py:161-212): each pixel's CE weighted by the
    inverse of its bin's EMA density, summed over the valid count."""
    flat, lab = _flat(logits, labels)
    _, hist, inds = _ghm_gradient_and_bins(flat, lab, ignore_label, state.bins)
    acc = _ema(state, hist)
    inv = 1.0 / torch.clamp_min(acc, 1e-12)
    weights = _bin_lookup(inv, inds, state.bins)
    ce = cross_entropy_per_pixel(flat, lab, ignore_label)
    loss = mesh.gsum((ce * weights).sum()) / (
        mesh.gsum((lab != ignore_label).sum()) + 1e-7)
    return loss, state.replace(acc_sum=acc)


def gdp_loss(logits: torch.Tensor, labels: torch.Tensor, state: GHMState,
             ignore_label: int = -1,
             pixel_weight: Optional[torch.Tensor] = None,
             n_weight_terms: int = 1) -> Tuple[torch.Tensor, GHMState]:
    """``GDPLoss`` (balance.py:218-303): the symmetrized histogram's EMA,
    the dense weight 1 - bin mass (0 for empty bins) normalized by its max;
    ``pixel_weight`` is added and the sum divided by ``n_weight_terms``."""
    flat, lab = _flat(logits, labels)
    _, hist, inds = _ghm_gradient_and_bins(flat, lab, ignore_label, state.bins)
    hist = (hist + torch.flip(hist, (0,))) * 0.5
    acc = _ema(state, hist)
    dense = 1.0 - acc / (acc.sum() + 1e-7)
    dense = torch.where(acc != 0, dense, torch.zeros_like(dense))
    dense = dense / (dense.max() + 1e-7)
    w = _bin_lookup(dense, inds, state.bins)
    if pixel_weight is not None:
        w = w + pixel_weight.reshape(-1)
    ce = cross_entropy_per_pixel(flat, lab, ignore_label)
    loss = mesh.gsum((ce * w / n_weight_terms).sum()) / (
        mesh.gsum((lab != ignore_label).sum()) + 1e-7)
    return loss, state.replace(acc_sum=acc)


def ups_loss(logits: torch.Tensor, labels: torch.Tensor,
             label_soft: Optional[torch.Tensor] = None, threshold: float = 0.7,
             ignore_label: int = -1,
             pixel_weight: Optional[torch.Tensor] = None,
             u: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``UPSLoss`` (balance.py:306-342): the hard uncertainty gate only --
    CE where u <= threshold, summed over the count of gated-in labelled
    pixels. ``u`` from ``label_soft``'s entropy, as in the JAX signature,
    or as the stage-3 step passes it, mined once by K8 (``ops/mine.py``)."""
    flat, lab = _flat(logits, labels)
    if label_soft is not None:
        u = pixel_entropy(label_soft.detach(), dim=1)
    elif u is None:
        raise ValueError("ups_loss: pass label_soft or u")
    u = u.detach().reshape(-1)
    ce = cross_entropy_per_pixel(flat, lab, ignore_label)
    ce = torch.where(u > threshold, torch.zeros_like(ce), ce)
    if pixel_weight is not None:
        ce = pixel_weight.reshape(-1) * ce
    valid_cnt = ((u <= threshold) & (lab != ignore_label)).sum()
    return mesh.gsum(ce.sum()) / (mesh.gsum(valid_cnt) + 1e-7)


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
    return mesh.gsum((w * ce).sum()) / (mesh.gsum(valid_cnt) + 1e-7)


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
