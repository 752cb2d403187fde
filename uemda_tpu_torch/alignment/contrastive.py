"""Pixel-level supervised contrastive loss and the batch-hard triplet loss.

The port's copy of ``uemda_tpu/alignment/contrastive.py`` (reference
``uemda/gast/contrastive.py`` and ``uemda/gast/triple.py:13-56``, dormant
there):

* :func:`triplet_loss`: batch-hard mining with MarginRankingLoss
  semantics;
* :func:`contrastive_anchors`: ``PixelContrastLoss._contrastive`` on
  sampled anchors, exactly;
* :func:`pixel_contrast_loss`: the anchor sampling in fixed shapes -- each
  (image, class) slot takes the ``n_view`` pixels of that class with the
  highest score, hard pixels (predicted otherwise) first and ties broken by
  ``noise``, an explicit (B, N, C) uniform draw (the JAX function draws it
  from its key); slots with fewer pixels are masked out of the loss.

Under data parallelism each runs on the gathered global batch
(``parallel/mesh.py: global_batch``).
"""

import torch

from uemda_tpu_torch.parallel.mesh import global_batch
from uemda_tpu_torch.utils.runtime import require_full_f32


@global_batch("inputs", "targets")
def triplet_loss(inputs: torch.Tensor, targets: torch.Tensor,
                 margin: float = 0.3) -> torch.Tensor:
    """inputs (N, K), targets (N,): ``mean(relu(margin - (d_an - d_ap)))``
    with the hardest positive and negative of each row."""
    sq = (inputs * inputs).sum(-1)
    d2 = sq[:, None] + sq[None, :] - 2.0 * (inputs @ inputs.T)
    dist = torch.sqrt(d2.clamp(min=1e-12))
    same = targets[:, None] == targets[None, :]
    d_ap = torch.where(same, dist, torch.full_like(dist, float("-inf")))
    d_an = torch.where(~same, dist, torch.full_like(dist, float("inf")))
    return (margin - (d_an.amin(dim=1) - d_ap.amax(dim=1))).clamp(min=0.0) \
        .mean()


@global_batch("feats", "labels")
def contrastive_anchors(feats: torch.Tensor, labels: torch.Tensor,
                        temperature: float = 0.1,
                        base_temperature: float = 0.07, eps: float = 1e-5
                        ) -> torch.Tensor:
    """(``contrastive.py:107-143``) feats (A, V, K), labels (A,). The
    denominator is ``exp(logit) + sum(negative exp)``, the self pair leaves
    the positives only, and the mean runs over all rows."""
    require_full_f32("contrastive_anchors")
    a, v, k = feats.shape
    f = feats.float().transpose(0, 1).reshape(v * a, k)  # view-major
    lab = labels.reshape(-1)
    mask = (lab[:, None] == lab[None, :]).float().repeat(v, v)
    logits = (f @ f.T) / temperature
    logits = logits - logits.amax(dim=1, keepdim=True).detach()
    pos_mask = mask * (1.0 - torch.eye(v * a, device=feats.device))
    neg_logits = (torch.exp(logits) * (1.0 - mask)).sum(dim=1, keepdim=True)
    log_prob = logits - torch.log(torch.exp(logits) + neg_logits + eps)
    mean_log_prob_pos = (pos_mask * log_prob).sum(dim=1) \
        / (pos_mask.sum(dim=1) + eps)
    return -(temperature / base_temperature) * mean_log_prob_pos.mean()


@global_batch("feats", "labels", "preds", "noise")
def pixel_contrast_loss(feats: torch.Tensor, labels: torch.Tensor,
                        preds: torch.Tensor, noise: torch.Tensor,
                        num_classes: int, n_view: int = 100,
                        temperature: float = 0.1,
                        base_temperature: float = 0.07,
                        ignore_label: int = -1) -> torch.Tensor:
    """feats (B, N, K); labels and preds (B, N) int; noise (B, N, C)
    uniform in [0, 1)."""
    b, n, k = feats.shape
    cls = torch.arange(num_classes, device=feats.device)
    lbl_eq = labels[:, :, None] == cls                            # (B, N, C)
    hard = lbl_eq & (preds[:, :, None] != cls)
    score = torch.where(lbl_eq, hard.float() + noise,
                        torch.full_like(noise, float("-inf")))
    top_idx = torch.topk(score.transpose(1, 2), n_view).indices   # (B, C, V)
    valid_slot = lbl_eq.sum(dim=1) >= n_view                      # (B, C)
    gathered = torch.gather(
        feats[:, None].expand(b, num_classes, n, k), 2,
        top_idx[..., None].expand(b, num_classes, n_view, k))
    anchors = gathered.reshape(-1, k).float()
    anchor_cls = cls[None, :, None].expand(b, num_classes, n_view).reshape(-1)
    anchor_valid = valid_slot[..., None].expand(b, num_classes, n_view) \
        .reshape(-1)
    anchors = anchors / torch.linalg.norm(anchors, dim=-1, keepdim=True) \
        .clamp(min=1e-12)
    eps = 1e-5
    both_valid = anchor_valid[:, None] & anchor_valid[None, :]
    pos_mask = (anchor_cls[:, None] == anchor_cls[None, :]) & both_valid
    eye = torch.eye(pos_mask.shape[0], dtype=torch.bool, device=feats.device)
    neg_mask = ~pos_mask & both_valid
    pos_mask = pos_mask & ~eye
    logits = anchors @ anchors.T / temperature
    ninf = torch.full_like(logits, float("-inf"))
    row_max = torch.where(both_valid, logits, ninf).amax(dim=1, keepdim=True)
    row_max = torch.where(torch.isfinite(row_max), row_max,
                          torch.zeros_like(row_max))
    logits = logits - row_max.detach()
    neg_logits = torch.where(neg_mask, torch.exp(logits),
                             torch.zeros_like(logits)).sum(1, keepdim=True)
    log_prob = logits - torch.log(torch.exp(logits) + neg_logits + eps)
    zero = torch.zeros_like(log_prob)
    mean_log_prob_pos = torch.where(pos_mask, log_prob, zero).sum(dim=1) \
        / (pos_mask.sum(dim=1) + eps)
    loss = -(temperature / base_temperature) * mean_log_prob_pos
    loss = torch.where(anchor_valid, loss, torch.zeros_like(loss))
    return loss.sum() / anchor_valid.sum().clamp(min=1)
