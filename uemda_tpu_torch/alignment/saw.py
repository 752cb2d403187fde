"""SAW -- semantic-aware whitening (the SAN-SAW line of work).

The port's copy of ``uemda_tpu/alignment/saw.py`` (reference
``uemda/gast/SAW.py:16-130``, dormant there): the channels are ranked per
class by the classifier's absolute weights and regrouped so that each group
holds one top channel of each selected class, gated by the sigmoid of its
weight; each group's instance covariance is pushed towards diagonal with a
margin-relaxed off-diagonal penalty. The rank is a stable descending sort,
as ``jnp.argsort``'s; the covariance runs in full f32, as JAX pins
``Precision.HIGHEST``. Under data parallelism it runs on the gathered
global batch.
"""

from typing import Sequence

import torch

from uemda_tpu_torch.parallel.mesh import global_batch
from uemda_tpu_torch.utils.runtime import require_full_f32


@global_batch("feats")
def saw_loss(feats: torch.Tensor, classifier_weights: torch.Tensor,
             selected_classes: Sequence[int], relax_denom: float = 2.0
             ) -> torch.Tensor:
    """feats (B, K, H, W); classifier_weights (C, K), the 1x1 classifier's
    kernel (its absolute value is taken here)."""
    require_full_f32("saw_loss")
    b, k, h, w = feats.shape
    sel = torch.as_tensor(list(selected_classes), dtype=torch.long,
                          device=feats.device)
    c = sel.shape[0]
    assert k % c == 0
    groups = k // c
    w_abs = classifier_weights.abs()
    order = torch.argsort(-w_abs, dim=1, stable=True)
    chan = order[sel][:, :groups]                       # (c, groups)
    gate = torch.sigmoid(torch.gather(w_abs[sel], 1, chan))
    x = feats.float()[:, chan.reshape(-1)].reshape(b, c, groups, h, w)
    x = x * gate[None, :, :, None, None]
    gx = x.permute(0, 2, 3, 4, 1).reshape(b, groups, h * w, c)
    eye = torch.eye(c, device=feats.device)
    upper = torch.triu(torch.ones(c, c, device=feats.device), diagonal=1)
    num_off = upper.sum()
    margin = 0.0 if relax_denom == 0 else num_off // relax_denom
    cov = torch.einsum("bgnc,bgnd->bgcd", gx, gx) / (h * w - 1) + 1e-5 * eye
    off = (cov * upper).abs().sum(dim=(-1, -2)) - margin
    loss = (off / num_off).clamp(min=0.0)
    return loss.sum(dim=0).sum() / b
