"""CORAL second-order domain alignment (arXiv:1607.01719 eq. 1).

The port's copy of ``uemda_tpu/alignment/coral.py:12-40`` (reference
``uemda/gast/coral.py:15-47``): the Frobenius distance between the
Bessel-corrected f32 feature covariances of the two domains, over 4 d^2.
The 2048 x 2048 products go to ``torch.matmul`` -- the JAX package leaves
them to XLA -- in full f32: ``Precision.HIGHEST`` there, PyTorch's default
(TF32 off for matmuls) here, which :func:`coral_loss` checks.
"""

import torch


def _covariance(x: torch.Tensor) -> torch.Tensor:
    n = x.shape[0]
    xm = x - x.mean(dim=0, keepdim=True)
    return torch.matmul(xm.t(), xm) / (n - 1)


def coral_loss(source: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """source/target: (N, K) flattened per-pixel features."""
    if torch.get_float32_matmul_precision() != "highest":
        # the products and their gradients would round through TF32
        raise RuntimeError(
            "coral_loss needs full-f32 matmuls (Precision.HIGHEST in the JAX "
            "package); TF32 is on: torch.get_float32_matmul_precision() is "
            f"{torch.get_float32_matmul_precision()!r}, PyTorch's default is "
            "'highest'")
    d = source.shape[1]
    diff = _covariance(source.float()) - _covariance(target.float())
    return (diff * diff).sum() / (4.0 * d * d)


def align_domain(feat_s: torch.Tensor, feat_t: torch.Tensor) -> torch.Tensor:
    """``Aligner.align_domain`` (alignment.py:79-84): flatten the (B, K, h, w)
    features to (B*h*w, K) pixel rows, as the JAX package flattens NHWC,
    and apply CORAL."""
    k = feat_s.shape[1]
    return coral_loss(feat_s.permute(0, 2, 3, 1).reshape(-1, k),
                      feat_t.permute(0, 2, 3, 1).reshape(-1, k))
