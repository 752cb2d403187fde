"""CORAL second-order domain alignment (arXiv:1607.01719 eq. 1).

The port's copy of ``uemda_tpu/alignment/coral.py`` (reference
``uemda/gast/coral.py:15-78``): the Frobenius distance between the
Bessel-corrected f32 feature covariances of the two domains, over 4 d^2
(its square root with ``is_sqrt``); :func:`coral_loss2` computes the
covariances in the expanded form (``CoralLoss2``).
The 2048 x 2048 products go to ``torch.matmul`` -- the JAX package leaves
them to XLA -- in full f32: ``Precision.HIGHEST`` there, PyTorch's default
(TF32 off for matmuls) here, which :func:`coral_loss` checks.
"""

import torch

from uemda_tpu_torch.parallel import mesh
from uemda_tpu_torch.utils.runtime import require_full_f32


def _covariance(x: torch.Tensor) -> torch.Tensor:
    """The covariance of the rows of the global batch: under data
    parallelism the mean and the centred product are summed over the
    ranks (two-pass, as on one rank)."""
    if mesh.world_size() == 1:
        n = x.shape[0]
        xm = x - x.mean(dim=0, keepdim=True)
        return torch.matmul(xm.t(), xm) / (n - 1)
    n = x.shape[0] * mesh.world_size()
    xm = x - mesh.gsum(x.sum(dim=0, keepdim=True)) / n
    return mesh.gsum(torch.matmul(xm.t(), xm)) / (n - 1)


def _frobenius(diff: torch.Tensor, d: int, is_sqrt: bool) -> torch.Tensor:
    loss = (diff * diff).sum()
    if is_sqrt:
        loss = torch.sqrt(loss)
    return loss / (4.0 * d * d)


def coral_loss(source: torch.Tensor, target: torch.Tensor,
               is_sqrt: bool = False) -> torch.Tensor:
    """source/target: (N, K) flattened per-pixel features."""
    require_full_f32("coral_loss")
    diff = _covariance(source.float()) - _covariance(target.float())
    return _frobenius(diff, source.shape[1], is_sqrt)


def _covariance2(x: torch.Tensor) -> torch.Tensor:
    """(X^T X - s^T s / n) / (n - 1), s the column sums, over the global
    batch: the expanded form, kept as JAX computes it (it cancels where
    the centred form does not, so the two differ in the low bits)."""
    n = x.shape[0] * mesh.world_size()
    s = mesh.gsum(x.sum(dim=0, keepdim=True))
    g = mesh.gsum(torch.matmul(x.t(), x))
    return (g - torch.matmul(s.t(), s) / n) / (n - 1)


def coral_loss2(source: torch.Tensor, target: torch.Tensor,
                is_sqrt: bool = False) -> torch.Tensor:
    """``CoralLoss2`` (``uemda_tpu/alignment/coral.py:43-59``, reference
    ``coral.py:50-78``): :func:`coral_loss` with the covariances in the
    expanded form, in full f32."""
    require_full_f32("coral_loss2")
    diff = _covariance2(source.float()) - _covariance2(target.float())
    return _frobenius(diff, source.shape[1], is_sqrt)


def align_domain(feat_s: torch.Tensor, feat_t: torch.Tensor) -> torch.Tensor:
    """``Aligner.align_domain`` (alignment.py:79-84): flatten the (B, K, h, w)
    features to (B*h*w, K) pixel rows, as the JAX package flattens NHWC,
    and apply CORAL."""
    k = feat_s.shape[1]
    return coral_loss(feat_s.permute(0, 2, 3, 1).reshape(-1, k),
                      feat_t.permute(0, 2, 3, 1).reshape(-1, k))
