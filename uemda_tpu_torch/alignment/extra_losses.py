"""Small loss and regularizer utilities of the reference toolbox.

The port's copy of ``uemda_tpu/alignment/extra_losses.py`` (reference
``uemda/utils/tools.py``): ``som`` (sparse online mining), the weighted
entropy and uniform-KLD regularizers of the adversarial baselines, BCE on
logits (the adversarial step's), the robust BCE, ``mixup`` (vertical-split
batch mixing) and ``ias_thresh`` (host numpy, the legacy IAST generator's
per-class thresholds).

Layouts are the port's: logits (B, C, H, W) and weights (B, 1, H, W);
images (B, 3, H, W) and labels (B, H, W). ``mixup`` takes its draws -- the
batch permutation and the split row -- as arguments, as every random op
of the port does. Under data parallelism the means and counts are the
global batch's, ``som`` ranks the gathered global batch and ``mixup``'s
permutation runs over it.
"""

from typing import Optional

import numpy as np
import torch

from uemda_tpu_torch.parallel import mesh
from uemda_tpu_torch.parallel.mesh import global_batch


@global_batch("loss")
def som(loss: torch.Tensor, ratio: float = 0.5) -> torch.Tensor:
    """Mean over the hardest ``ratio`` fraction of ``loss``, zero entries
    left out of the count (``tools.py:291-302``)."""
    flat = loss.reshape(-1)
    k = max(int(ratio * flat.shape[0]), 1)
    top = torch.topk(flat, k).values
    return top.sum() / ((top != 0).sum() + 1e-6)


def entropy_loss(logits: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """Weighted softmax entropy over the class axis, summed and divided by
    the number of positive weights (``tools.py:376-385``)."""
    logp = torch.log_softmax(logits, dim=1)
    ent = -(torch.softmax(logits, dim=1) * weight * logp)
    return mesh.gsum(ent.sum()) / mesh.gsum((weight > 0).sum()).clamp(min=1)


def kld_loss(logits: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """KL divergence to the uniform class distribution, weighted
    (``tools.py:388-398``)."""
    c = logits.shape[1]
    kld = -(1.0 / c) * weight * torch.log_softmax(logits, dim=1)
    return mesh.gsum(kld.sum()) / mesh.gsum((weight > 0).sum()).clamp(min=1)


def bce_logits_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Mean binary cross entropy on logits, in the JAX package's stable
    form ``max(x, 0) - x t + log1p(exp(-|x|))`` (``tools.py:263-267``)."""
    return mesh.gmean(pred.clamp(min=0) - pred * target
                      + torch.log1p(torch.exp(-pred.abs())))


def robust_binary_crossentropy(pred: torch.Tensor, tgt: torch.Tensor
                               ) -> torch.Tensor:
    """Elementwise BCE on probabilities with 1e-6 guards
    (``tools.py:270-273``)."""
    return -(tgt * torch.log(pred + 1e-6)
             + (1.0 - tgt) * torch.log(1.0 - pred + 1e-6))


def mixup(perm: torch.Tensor, lam: int, s_img, s_lab, t_img, t_lab):
    """Vertical-split batch mixing (``tools.py:155-170``): rows above
    ``lam`` keep the source and take the permuted target below, and the
    other way round for the new target. Returns (source image, source
    label, target image, target label)."""
    h = s_img.shape[2]
    cut = torch.arange(h, device=s_img.device) < lam
    # ``perm`` permutes the global batch: this rank's rows of the gathered
    # permuted target
    t_img_p = mesh.shard_rows(mesh.gather_rows(t_img)[perm])
    t_lab_p = mesh.shard_rows(mesh.gather_rows(t_lab)[perm])
    img_cut, lab_cut = cut[None, None, :, None], cut[None, :, None]
    return (torch.where(img_cut, s_img, t_img_p),
            torch.where(lab_cut, s_lab, t_lab_p),
            torch.where(img_cut, t_img_p, s_img),
            torch.where(lab_cut, t_lab_p, s_lab))


def ias_thresh(conf_dict, n_class: int, alpha: float,
               w: Optional[np.ndarray] = None, gamma: float = 1.0
               ) -> np.ndarray:
    """Per-class percentile thresholds (``tools.py:323-332``): class ``i``
    with recorded confidences gets their ``100 (1 - alpha w_i^gamma)``-th
    percentile, the others 1."""
    if w is None:
        w = np.ones(n_class)
    cls_thresh = np.ones(n_class, dtype=np.float32)
    for idx in range(n_class):
        if conf_dict.get(idx):
            cls_thresh[idx] = np.percentile(
                np.array(conf_dict[idx]), 100 * (1 - alpha * w[idx] ** gamma))
    return cls_thresh
