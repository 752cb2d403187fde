"""Label utilities: ignore-aware one-hot and majority-vote label downscaling.

The port's copy of ``uemda_tpu/ops/labels.py`` (reference
``uemda/gast/alignment.py:468-509``):
  * :func:`one_hot_ignore` / :func:`index_to_onehot`: the ignore label maps
    to an all-zero row (``Aligner._index2onehot``);
  * :func:`downscale_label`: the ``DownscaleLabel`` 16 x 16 majority vote,
    with the ignore label voting as bucket C and ``min_ratio`` 0.75.

Labels are int (B, H, W) with ignore_label -1. Everything here is exact:
the vote counts are integers and the ratio is the count over s*s in f32,
as the JAX package's f32 mean of a 0/1 one-hot.
"""

import torch


def one_hot_ignore(label: torch.Tensor, num_classes: int,
                   ignore_label: int = -1) -> torch.Tensor:
    """(...) int -> (..., C) f32 one-hot with all-zero rows at ignored
    pixels (and at ids outside [0, C), as the JAX comparison gives)."""
    classes = torch.arange(num_classes, device=label.device)
    oh = label[..., None].long() == classes
    return (oh & (label != ignore_label)[..., None]).float()


def index_to_onehot(label: torch.Tensor, num_classes: int,
                    ignore_label: int = -1) -> torch.Tensor:
    """(B, H, W) int -> (B*H*W, C) f32 one-hot, zeros for ignore."""
    return one_hot_ignore(label, num_classes, ignore_label).reshape(
        -1, num_classes)


def downscale_label(label: torch.Tensor, scale_factor: int = 16,
                    num_classes: int = 7, ignore_label: int = -1,
                    min_ratio: float = 0.75) -> torch.Tensor:
    """(B, H, W) -> (B, H/s, W/s) int32 majority vote per s x s cell. The
    ignore label votes as class C; a cell won by it, or whose winner holds
    less than ``min_ratio`` of the cell, is ignore. Ties go to the lower
    class, as ``jnp.argmax``."""
    b, h, w = label.shape
    s = scale_factor
    if h % s or w % s:
        raise ValueError(f"downscale_label: {h}x{w} is not divisible by {s}")
    lbl = torch.where(label == ignore_label,
                      torch.full_like(label, num_classes), label).long()
    buckets = torch.arange(num_classes + 1, device=label.device)
    oh = lbl[..., None] == buckets                      # (B, H, W, C+1)
    counts = oh.reshape(b, h // s, s, w // s, s, num_classes + 1).sum(
        dim=(2, 4), dtype=torch.int32)
    max_count, out = counts.max(dim=-1)
    out = out.to(torch.int32)
    ratio = max_count.float() / float(s * s)
    ignore = (out == num_classes) | (ratio < min_ratio)
    return torch.where(ignore, torch.full_like(out, ignore_label), out)
