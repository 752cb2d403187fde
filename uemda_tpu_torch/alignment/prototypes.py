"""Prototype alignment: EMA class prototypes and multi-view pseudo-label
refinement.

The port's copy of ``uemda_tpu/alignment/prototypes.py:41-391`` (reference
``Aligner``, ``uemda/gast/alignment.py:24-481``). The prototypes and the
running sums of ``init_prototypes`` are an explicit :class:`AlignerState`
of f32 tensors; every update returns a new state, as in the JAX package.

Layouts are the port's: features (B, K, h, w) and soft labels or logits
(B, C, H, W), NCHW in logical order; hard labels and superpixel maps
(B, H, W). A feature map's pixels are taken in (b, y, x) order, as the JAX
package flattens NHWC, so per-pixel rows line up between the two.

Views of :func:`label_refine` (``alignment.py:194-293``):
  'p' prototype view  -- inverse Pearson distance feature-vs-prototypes,
                         upsampled, softmax(T=1), max-normalized;
  'l' prediction view -- temperature softmax of the upsampled head logits,
                         averaged over heads, max-normalized;
  's' superpixel view -- per-superpixel max of the soft label (K5), gathered
                         back (K7), softmax(T), max-normalized; boundary
                         pixels keep the other views' weight;
  'n' neighbour view  -- top-k feature neighbours vote on the
                         prototype-argmax class, distance-rank weighted.

Precision: every product the JAX package pins at ``Precision.HIGHEST``
(``pearson_dist``, the local prototypes, ``update_avg`` and the 'n' view's
Gram matrix) runs in full f32, which :func:`require_full_f32` checks.
"""

import dataclasses
import math
from typing import Optional, Sequence, Tuple, Union

import torch

from uemda_tpu_torch.ops.labels import (
    downscale_label,
    index_to_onehot,
    one_hot_ignore,
)
from uemda_tpu_torch.ops.resize import resize_bilinear, upsample_logits
from uemda_tpu_torch.ops.segment import superpixel_view_probs
from uemda_tpu_torch.parallel import mesh
from uemda_tpu_torch.utils.runtime import require_full_f32, resolve_device

EPS = 1e-7


@dataclasses.dataclass
class AlignerState:
    prototypes: torch.Tensor  # (C, K) f32
    data_sum: torch.Tensor    # (C, K) running sum for init_avg
    data_cnt: torch.Tensor    # (C, 1)
    decay: float = 0.996
    ignore_label: int = -1

    def replace(self, **changes) -> "AlignerState":
        return dataclasses.replace(self, **changes)


def init_aligner(class_num: int, feat_channels: int = 2048,
                 decay: float = 0.996, ignore_label: int = -1,
                 prototypes=None, device=None) -> AlignerState:
    """Zero prototypes (or the given (C, K) ones) and zero running sums on
    ``device`` (None: the card)."""
    device = resolve_device(device)
    if prototypes is None:
        prototypes = torch.zeros(class_num, feat_channels)
    protos = torch.as_tensor(prototypes, dtype=torch.float32).to(device)
    if tuple(protos.shape) != (class_num, feat_channels):
        raise ValueError(f"prototypes {tuple(protos.shape)} for {class_num} "
                         f"classes of {feat_channels} channels")
    return AlignerState(
        prototypes=protos.clone(),
        data_sum=torch.zeros(class_num, feat_channels, device=device),
        data_cnt=torch.zeros(class_num, 1, device=device),
        decay=decay, ignore_label=ignore_label)


def pixels(feat: torch.Tensor) -> torch.Tensor:
    """(B, K, h, w) -> (B*h*w, K) rows in (b, y, x) order (a view for a
    channels_last map)."""
    return feat.permute(0, 2, 3, 1).reshape(-1, feat.shape[1])


def _to_nchw(rows: torch.Tensor, b: int, h: int, w: int) -> torch.Tensor:
    """(B*h*w, C) rows -> (B, C, h, w) channels_last."""
    return rows.reshape(b, h, w, -1).permute(0, 3, 1, 2)


# ---------------------------------------------------------------- distances


@torch.no_grad()
def pearson_dist(feat1: torch.Tensor, feat2: torch.Tensor) -> torch.Tensor:
    """Pairwise Pearson distance in [0, 1] between (n, K) and (m, K) rows
    (``alignment.py:424-451``): unbiased std, no gradient, as the
    reference's ``.detach()``."""
    require_full_f32("pearson_dist")
    k = feat1.shape[-1]
    f1, f2 = feat1.float(), feat2.float()
    c1 = f1 - f1.mean(dim=-1, keepdim=True)
    c2 = f2 - f2.mean(dim=-1, keepdim=True)
    cov = torch.matmul(c1, c2.t()) / (k - 1 + EPS)
    s1 = torch.sqrt((c1 * c1).sum(-1) / (k - 1))
    s2 = torch.sqrt((c2 * c2).sum(-1) / (k - 1))
    denom = s1[:, None] * s2[None, :]
    return (-cov / (denom + EPS) + 1.0) * 0.5


# ---------------------------------------------------------- prototype maths


def compute_local_prototypes(feat: torch.Tensor, label_down: torch.Tensor,
                             prototypes: torch.Tensor, class_num: int,
                             ignore_label: int = -1) -> torch.Tensor:
    """Mini-batch class means of the (B, K, h, w) features under the
    (B, h, w) labels (``alignment.py:328-355``); a class absent from the
    batch keeps its global prototype. One (C, N) x (N, K) product in full
    f32 (the prototypes are long-lived EMA state)."""
    require_full_f32("compute_local_prototypes")
    oh = index_to_onehot(label_down, class_num, ignore_label)   # (N, C)
    n_instance = mesh.gsum(oh.sum(dim=0)[:, None])             # (C, 1)
    sums = mesh.gsum(torch.matmul(oh.t(), pixels(feat).float()))
    local = sums / (n_instance + EPS)
    return torch.where(n_instance < 1, prototypes, local)


@torch.no_grad()
def update_prototype(state: AlignerState, feat: torch.Tensor,
                     label_full: torch.Tensor, class_num: int,
                     scale_factor: int = 16
                     ) -> Tuple[AlignerState, torch.Tensor]:
    """``Aligner.update_prototype`` (alignment.py:86-90): downscale the label
    to the feature stride and move the prototypes toward the batch's class
    means by the EMA. Returns (new state, downscaled label)."""
    label_down = downscale_label(label_full, scale_factor, class_num,
                                 state.ignore_label)
    local = compute_local_prototypes(feat.detach(), label_down,
                                     state.prototypes, class_num,
                                     state.ignore_label)
    new = (1.0 - state.decay) * local + state.decay * state.prototypes
    return state.replace(prototypes=new), label_down


@torch.no_grad()
def update_avg(state: AlignerState, feat: torch.Tensor,
               label_full: torch.Tensor, class_num: int,
               scale_factor: int = 16) -> AlignerState:
    """``Aligner.update_avg`` (alignment.py:107-119): add the batch's
    per-class feature sums and counts, for the exact-average init."""
    require_full_f32("update_avg")
    label_down = downscale_label(label_full, scale_factor, class_num,
                                 state.ignore_label)
    oh = index_to_onehot(label_down, class_num, state.ignore_label)
    sums = mesh.gsum(torch.matmul(oh.t(), pixels(feat.detach()).float()))
    return state.replace(
        data_sum=state.data_sum + sums,
        data_cnt=state.data_cnt + mesh.gsum(oh.sum(dim=0)[:, None]))


def init_avg(state: AlignerState) -> AlignerState:
    """``Aligner.init_avg`` (alignment.py:121-126)."""
    return state.replace(prototypes=state.data_sum / (state.data_cnt + EPS))


# ------------------------------------------------------------ margin losses


def _class_align_loss(p1: torch.Tensor, p2: torch.Tensor, class_num: int,
                      margin: float = 0.3, hard_ratio: float = 0.3
                      ) -> torch.Tensor:
    """(alignment.py:357-384) margin loss between two prototype sets."""
    dist = pearson_dist(p1, p2)                                 # (C, C)
    hard_num = min(math.ceil(hard_ratio * class_num), class_num - 1)
    eye_neg = 1.0 - torch.eye(class_num, device=dist.device)
    # the k+1 smallest, ascending (the zeroed diagonal is among them)
    neg = torch.topk(dist * eye_neg, hard_num + 1, dim=-1, largest=False,
                     sorted=True).values
    d_pos = torch.diagonal(dist)[:, None]
    loss = torch.clamp(d_pos - neg[:, 1:] + margin, min=1e-6)
    return loss.mean()


def align_class(state: AlignerState, feat_s: torch.Tensor,
                label_s: torch.Tensor, class_num: int,
                feat_t: Optional[torch.Tensor] = None,
                label_t: Optional[torch.Tensor] = None,
                scale_factor: int = 16) -> torch.Tensor:
    """``Aligner.align_class`` (alignment.py:128-154)."""
    ig = state.ignore_label
    label_down = downscale_label(label_s, scale_factor, class_num, ig)
    # the global batch's halves (this rank's rows of each)
    first, second = mesh.halves(feat_s.shape[0])
    p1 = compute_local_prototypes(feat_s[first], label_down[first],
                                  state.prototypes, class_num, ig)
    p2 = compute_local_prototypes(feat_s[second], label_down[second],
                                  state.prototypes, class_num, ig)
    loss_inter = _class_align_loss(p1, p2, class_num)
    if feat_t is None or label_t is None:
        return loss_inter
    ps = compute_local_prototypes(feat_s, label_down, state.prototypes,
                                  class_num, ig)
    label_t_down = downscale_label(label_t, scale_factor, class_num, ig)
    pt = compute_local_prototypes(feat_t, label_t_down, state.prototypes,
                                  class_num, ig)
    return 0.5 * (loss_inter + _class_align_loss(ps, pt, class_num))


def _instance_align_loss(state: AlignerState, feat: torch.Tensor,
                         label_down: torch.Tensor, class_num: int,
                         margin: float = 0.3, hard_ratio: float = 0.3
                         ) -> torch.Tensor:
    """(alignment.py:386-422) margin loss of instances against the
    prototypes."""
    y = label_down.reshape(-1)
    not_ignored = (y != state.ignore_label).float()[:, None]
    mask_pos = index_to_onehot(label_down, class_num, state.ignore_label)
    dist = pearson_dist(pixels(feat), state.prototypes)          # (N, C)
    hard_num = min(math.ceil(hard_ratio * class_num) + 1, class_num)
    neg = torch.topk(dist * (1.0 - mask_pos), hard_num, dim=-1,
                     largest=False, sorted=True).values
    d_pos = (dist * mask_pos).sum(dim=1, keepdim=True)
    loss = torch.clamp(d_pos - neg[:, 1:] + margin, min=1e-6) * not_ignored
    cnt = mesh.gsum(not_ignored.sum()) * (hard_num - 1)
    return mesh.gsum(loss.sum()) / (cnt + EPS)


def align_instance(state: AlignerState, feat_s: torch.Tensor,
                   label_s: torch.Tensor, class_num: int,
                   feat_t: Optional[torch.Tensor] = None,
                   label_t: Optional[torch.Tensor] = None,
                   scale_factor: int = 16) -> torch.Tensor:
    """``Aligner.align_instance`` (alignment.py:156-163)."""
    ig = state.ignore_label
    ld = downscale_label(label_s, scale_factor, class_num, ig)
    loss = _instance_align_loss(state, feat_s, ld, class_num)
    if feat_t is not None and label_t is not None:
        ltd = downscale_label(label_t, scale_factor, class_num, ig)
        loss = 0.5 * (loss + _instance_align_loss(state, feat_t, ltd,
                                                  class_num))
    return loss


# ------------------------------------------------------------- label refine


def _softmax_t(x: torch.Tensor, temp: float, dim: int = 1) -> torch.Tensor:
    return torch.softmax(x / temp, dim=dim)


def _max_normalize(w: torch.Tensor, dim: int = 1) -> torch.Tensor:
    return w / (w.amax(dim=dim, keepdim=True) + EPS)


def _prototype_simi(state: AlignerState, feat: torch.Tensor, out_hw
                    ) -> torch.Tensor:
    """Inverse Pearson distance of every feature pixel to every prototype,
    upsampled to ``out_hw`` (align_corners), softmax(T=1), max-normalized:
    (B, C, H, W)."""
    b, _, h, w = feat.shape
    simi = 1.0 / pearson_dist(pixels(feat), state.prototypes)
    simi = resize_bilinear(_to_nchw(simi, b, h, w), out_hw, align_corners=True)
    return _max_normalize(_softmax_t(simi, 1.0))


@torch.no_grad()
def label_refine(state: AlignerState, label_soft: torch.Tensor,
                 feat: torch.Tensor,
                 preds: Union[torch.Tensor, Sequence[torch.Tensor]],
                 sup: Optional[torch.Tensor] = None, mode: str = "all",
                 temp: float = 2.0, topk: int = 32, max_segments: int = 2048
                 ) -> torch.Tensor:
    """Multi-view refinement of soft pseudo labels (``alignment.py:194-293``).

    label_soft: (B, C, H, W) soft label at full resolution; feat:
    (B, K, h, w) stride-16 features; preds: head logits (B, C, h, w) or a
    list of them; sup: (B, H, W) superpixel ids (the 's' view runs only
    with them). ``mode``: 'all' | 'p' | 'l' | 's' | 'n'. Returns the
    refined (B, C, H, W) soft label, renormalized over classes. No
    gradient: every view is the reference's detached weight."""
    if mode not in ("all", "p", "l", "s", "n"):
        raise ValueError(f"label_refine: unknown mode {mode!r}")
    b, _, h, w = feat.shape
    c, ho, wo = label_soft.shape[1:]
    weight = None

    if mode in ("all", "p"):  # prototype view (alignment.py:215-223)
        weight = _prototype_simi(state, feat, (ho, wo))

    if mode in ("all", "l"):  # prediction view (alignment.py:225-236)
        heads = preds if isinstance(preds, (list, tuple)) else [preds]
        lw = sum(_softmax_t(upsample_logits(p.float(), (ho, wo)), temp)
                 for p in heads) / len(heads)
        lw = _max_normalize(lw)
        weight = lw if weight is None else weight + lw

    if mode in ("all", "s") and sup is not None:  # superpixel view (:238-258)
        # the boundary id is the (global) batch's max, not each sample's
        ignored = (sup == mesh.gmax(sup.max()))[:, None]   # (B, 1, H, W)
        pooled = superpixel_view_probs(label_soft, sup, max_segments)
        sw = _max_normalize(_softmax_t(pooled, temp))
        if mode == "all":
            weight = torch.where(ignored, weight, weight * sw)
        else:
            weight = torch.where(ignored, torch.ones_like(sw), sw)

    if mode == "n":  # neighbour view (alignment.py:260-286)
        require_full_f32("label_refine's neighbour view")
        fd = pixels(feat).float()
        # the neighbours come from every pixel of the global batch: this
        # rank's rows against the gathered ones
        every = mesh.gather_rows(fd)
        sq, sq_all = (fd * fd).sum(-1), (every * every).sum(-1)
        d2 = sq[:, None] + sq_all[None, :] - 2.0 * torch.matmul(fd, every.t())
        simi = 1.0 / (torch.sqrt(torch.clamp(d2, min=0.0)) + EPS)
        topk_idx = torch.topk(simi, topk + 1, dim=-1).indices
        hard = torch.argmax(1.0 / pearson_dist(every, state.prototypes),
                            dim=-1)
        neigh_cls = hard[topk_idx[:, 1:]]                   # (N, topk)
        importance = 1.0 - torch.arange(topk, dtype=torch.float32,
                                        device=fd.device) / topk
        oh = torch.nn.functional.one_hot(neigh_cls, c).float()
        cls_num = (oh * importance[None, :, None]).sum(dim=1)   # (N, C)
        ratio = cls_num / (cls_num.sum(-1, keepdim=True) + EPS)
        nw = _max_normalize(_softmax_t(ratio, temp, dim=-1), dim=-1)
        weight = resize_bilinear(_to_nchw(nw, b, h, w), (ho, wo),
                                 align_corners=True)

    if weight is None:
        return label_soft
    refined = weight * label_soft
    return refined / (refined.sum(dim=1, keepdim=True) + EPS)


@torch.no_grad()
def update_prototype_by_target(state: AlignerState, feat_t: torch.Tensor,
                               label_t_soft: torch.Tensor) -> AlignerState:
    """``Aligner.update_prototype_bytarget`` (alignment.py:92-105): the
    soft-label-weighted feature means, EMA'd into the prototypes."""
    require_full_f32("update_prototype_by_target")
    h, w = feat_t.shape[2:]
    soft_down = resize_bilinear(label_t_soft.float(), (h, w),
                                align_corners=True)
    f, s = pixels(feat_t.detach()).float(), pixels(soft_down)
    local = mesh.gsum(torch.matmul(s.t(), f)) / (f.shape[0]
                                                 * mesh.world_size())
    new = (1.0 - state.decay) * local + state.decay * state.prototypes
    return state.replace(prototypes=new)


@torch.no_grad()
def prototype_weight_for_pixels(state: AlignerState, feat: torch.Tensor,
                                label_hard: torch.Tensor, class_num: int
                                ) -> torch.Tensor:
    """``Aligner.get_prototype_weight_4pixel`` (alignment.py:295-309): each
    pixel's prototype-view weight of its labelled class, 0 at ignored
    pixels; (B*H*W,) in (b, y, x) order."""
    ho, wo = label_hard.shape[-2:]
    simi = _prototype_simi(state, feat, (ho, wo))               # (B, C, H, W)
    oh = one_hot_ignore(label_hard, class_num, state.ignore_label)
    return (simi.permute(0, 2, 3, 1) * oh).sum(-1).reshape(-1)
