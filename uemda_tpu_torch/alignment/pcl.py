"""Prototype contrastive loss.

The port's copy of ``uemda_tpu/alignment/pcl.py`` (reference
``PrototypeContrastiveLoss``, ``uemda/loss.py:10-47``): cross entropy over
(L2-normalized feature) . (L2-normalized prototype) / T logits, with
ignored pixels out of the mean. The reference drops ignored rows by boolean
indexing; here, as in the JAX package, the same mean is a masked sum over
max(valid count, 1), both over the global batch under data parallelism.
The normalization is ``F.normalize``'s,
x / max(||x||, 1e-12). The prototypes take no gradient.
"""

import torch

from uemda_tpu_torch.alignment.losses import cross_entropy_per_pixel
from uemda_tpu_torch.alignment.prototypes import pixels
from uemda_tpu_torch.parallel import mesh


def _l2_normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    n = torch.sqrt((x * x).sum(dim=-1, keepdim=True))
    return x / torch.clamp(n, min=eps)


def prototype_contrastive_loss(prototypes: torch.Tensor, feat: torch.Tensor,
                               labels: torch.Tensor, temperature: float = 8.0,
                               ignore_label: int = -1) -> torch.Tensor:
    """prototypes (C, K); feat (B, K, h, w); labels (B, h, w) int."""
    f = _l2_normalize(pixels(feat).float())
    p = _l2_normalize(prototypes.detach().float())
    logits = torch.matmul(f, p.t()) / temperature               # (N, C)
    y = labels.reshape(-1)
    ce = cross_entropy_per_pixel(logits, y, ignore_label)
    valid = mesh.gsum((y != ignore_label).sum().float())
    return mesh.gsum(ce.sum()) / torch.clamp(valid, min=1.0)
