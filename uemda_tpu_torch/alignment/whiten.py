"""Class-aware grouped feature whitening loss.

The port's copy of ``uemda_tpu/alignment/whiten.py`` (reference
``ClassWareWhitening``, ``uemda/gast/class_ware_whiten.py:14-65``; the
reference builds the whitener but no tool calls it). Per class and per
channel group, the masked feature covariance is pushed towards the
identity with an MSE; a class with at most one pixel contributes the
identity (loss 0), as the reference's early return. The covariances of
all groups of a class are one batched GEMM. Under data parallelism the
loss runs on the gathered global batch.
"""

from typing import Sequence

import torch

from uemda_tpu_torch.parallel.mesh import global_batch


def _group_covariances(fg: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """fg (groups, N, k), mask (N,) in {0, 1} -> (groups, k, k) masked
    covariances with the reference's centering
    (``class_ware_whiten.py:32-39``), the identity where the mask holds at
    most one pixel."""
    k = fg.shape[2]
    num = mask.sum()
    xm = fg * mask[None, :, None]
    xc = xm - xm.sum(dim=1, keepdim=True) * mask[None, :, None] \
        / num.clamp(min=1.0)
    cov = torch.bmm(xc.transpose(1, 2), xc) / (num - 1.0).clamp(min=1.0)
    eye = torch.eye(k, device=fg.device)
    return torch.where(num <= 1, eye.expand_as(cov), cov)


@global_batch("feats", "labels")
def class_ware_whitening_loss(feats: torch.Tensor, labels: torch.Tensor,
                              class_ids: Sequence[int], groups: int = 32
                              ) -> torch.Tensor:
    """feats (B, K, h, w); labels (B, h, w) at the feature's resolution.
    The sum over ``class_ids`` and groups of mean((cov - I)^2)."""
    kdim = feats.shape[1]
    assert kdim % groups == 0
    step = kdim // groups
    f = feats.float().permute(0, 2, 3, 1).reshape(-1, kdim)
    y = labels.reshape(-1)
    fg = f.reshape(-1, groups, step).transpose(0, 1)  # (groups, N, step)
    eye = torch.eye(step, device=feats.device)
    total = []
    for cid in class_ids:
        covs = _group_covariances(fg, (y == cid).float())
        total.append(((covs - eye) ** 2).mean(dim=(1, 2)).sum())
    return torch.stack(total).sum()
