"""MSC loss -- the multi-similarity contrastive criterion of ILA-DA.

The port's copy of ``uemda_tpu/alignment/msc.py`` (reference
``uemda/gast/MSCLoss.py``, dormant there): inverse-distance similarity
between source and target instances; each target takes the majority label
of its ``k`` most similar sources (the first class on a tie, as
``argmax``), a confidence from its top-``m`` like- and unlike-labelled
similarities, and the ``mu`` most confident targets enter a masked-softmax
contrastive objective over the source rows that have both a positive and a
negative. Fixed shapes, top-k in place of the reference's loops, over
the global batch under data parallelism (gathered).
"""

import torch

from uemda_tpu_torch.parallel.mesh import global_batch


@global_batch("src_features", "src_labels", "tgt_features")
def msc_loss(src_features: torch.Tensor, src_labels: torch.Tensor,
             tgt_features: torch.Tensor, num_classes: int, k: int = 5,
             m: int = 3, mu: int = 8) -> torch.Tensor:
    """src_features (N, D), src_labels (N,) int, tgt_features (T, D)."""
    s, t = src_features.float(), tgt_features.float()
    tn = t.shape[0]
    d2 = ((s[:, None] - t[None]) ** 2).sum(-1)
    sim = 1.0 / (torch.sqrt(d2.clamp(min=0.0)) + 1.0)          # (N, T)
    topk_idx = torch.topk(sim.T, k).indices                       # (T, k)
    votes = torch.nn.functional.one_hot(src_labels[topk_idx].long(),
                                        num_classes).sum(dim=1)
    tgt_lbl = votes.argmax(dim=-1)                                # (T,)
    like = src_labels[:, None] == tgt_lbl[None, :]                # (N, T)
    ninf = torch.full_like(sim, float("-inf"))
    nln = torch.topk(torch.where(like, sim, ninf).T, m).values    # (T, m)
    nun = torch.topk(torch.where(~like, sim, ninf).T, m).values
    nln = torch.where(torch.isfinite(nln), nln, torch.zeros_like(nln))
    nun = torch.where(torch.isfinite(nun), nun, torch.zeros_like(nun))
    conf = nln.sum(-1) / (nun.sum(-1) + 1e-9)
    keep_idx = torch.topk(conf, min(mu, tn)).indices
    kept_sim, kept_lbl = sim[:, keep_idx], tgt_lbl[keep_idx]
    mask_sim = (src_labels[:, None] == kept_lbl[None, :]).float()
    row_ok = (mask_sim.sum(dim=1) > 0) & ((1 - mask_sim).sum(dim=1) > 0)
    logits = torch.where(row_ok[:, None], kept_sim,
                         torch.full_like(kept_sim, float("-inf")))
    pos_mass = (torch.softmax(logits, dim=1) * mask_sim).sum(dim=1)
    loss_rows = -torch.log(pos_mass.clamp(min=1e-9))
    # a row without a positive or a negative is NaN here; it counts as 0,
    # as JAX's product with a False mask gives
    loss_rows = torch.where(row_ok, loss_rows, torch.zeros_like(loss_rows))
    return loss_rows.sum() / row_ok.sum().clamp(min=1)
