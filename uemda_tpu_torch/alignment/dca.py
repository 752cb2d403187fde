"""DCA class-correlation regularizers (ICR / CCR and their MSE forms).

The port's copy of ``uemda_tpu/alignment/dca.py`` (reference
``uemda/dca_modules.py:14-188``): prediction-weighted per-class context
vectors and intra- and cross-domain Pearson-correlation regularization.
The (n, n) correlation is one GEMM of the centered context rows, and the
context one batched GEMM; both run in full f32, as JAX pins
``Precision.HIGHEST`` (:func:`require_full_f32`). Predictions are the
heads' stride-16 logits (B, C, h, w), features (B, K, h, w). The batch
means and halves are the global batch's under data parallelism.
"""

import torch

from uemda_tpu_torch.parallel import mesh
from uemda_tpu_torch.utils.runtime import require_full_f32

EPS = 1e-7


def get_context(preds: torch.Tensor, feats: torch.Tensor,
                ignore_bg: bool = False) -> torch.Tensor:
    """Prediction-weighted class context vectors (``dca_modules.py:20-34``):
    preds (B, C, h, w) probabilities, feats (B, K, h, w) -> (B, C[-1], K),
    L2-normalized over the class axis."""
    require_full_f32("DCA's class context")
    b, c = preds.shape[:2]
    k = feats.shape[1]
    hw = preds.shape[2] * preds.shape[3]   # b may be 0: a rank's empty half
    p = preds.float().reshape(b, c, hw)
    f = feats.float().reshape(b, k, hw)
    vectors = torch.bmm(p, f.transpose(1, 2)) / (p.sum(dim=2)[..., None] + EPS)
    if ignore_bg:
        vectors = vectors[:, 1:, :]
    norm = torch.sqrt((vectors * vectors).sum(dim=1, keepdim=True))
    return vectors / norm.clamp(min=1e-12)


def _corrcoef_rows(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(n, k) x (m, k) -> (n, m) Pearson correlation of the rows."""
    require_full_f32("DCA's correlation")
    ac = a - a.mean(dim=1, keepdim=True)
    bc = b - b.mean(dim=1, keepdim=True)
    sa = torch.sqrt((ac * ac).sum(dim=1))
    sb = torch.sqrt((bc * bc).sum(dim=1))
    return (ac @ bc.T) / (sa[:, None] * sb[None, :]).clamp(min=1e-12)


def _regularize(cor_mat: torch.Tensor) -> torch.Tensor:
    """(``dca_modules.py:59-76``) ``-log`` of the diagonal plus the mean
    ``-log(1 - max(offdiag, 1e-6))`` over the off-diagonal."""
    n = cor_mat.shape[0]
    pos = -torch.log(torch.diagonal(cor_mat).clamp(min=1e-6)).mean()
    off = 1.0 - torch.eye(n, device=cor_mat.device)
    offdiag = torch.where(off > 0, cor_mat, torch.full_like(cor_mat, 1e-6))
    neg = -torch.log(1.0 - offdiag.clamp(min=1e-6))
    return pos + (neg * off).sum() / (n * (n - 1))


def _mean_prob(p1: torch.Tensor, p2: torch.Tensor) -> torch.Tensor:
    return (torch.softmax(p1, dim=1) + torch.softmax(p2, dim=1)) / 2


def _batch_mean(ctx: torch.Tensor, rows: int) -> torch.Tensor:
    """The mean over the samples of ``ctx`` (B, C, K): of the ``rows``
    samples of the global batch they stand for, under data parallelism."""
    if mesh.world_size() == 1:
        return ctx.mean(0)
    return mesh.gsum(ctx.sum(0)) / rows


def icr(preds1, preds2, feats, num_classes: int = None,
        ignore_bg: bool = True) -> torch.Tensor:
    """Intra-domain covariance regularization (``dca_modules.py:79-105``):
    the batch's two halves' contexts, correlated; the probabilities are
    detached, the features carry the gradient."""
    probs = _mean_prob(preds1, preds2).detach()
    gb = probs.shape[0] * mesh.world_size()
    first, second = mesh.halves(probs.shape[0])    # of the global batch
    c1 = _batch_mean(get_context(probs[first], feats[first], ignore_bg),
                     gb // 2)
    c2 = _batch_mean(get_context(probs[second], feats[second], ignore_bg),
                     gb - gb // 2)
    return _regularize(_corrcoef_rows(c1, c2))


def ccr(s_preds1, s_preds2, s_feats, t_preds1, t_preds2, t_feats,
        num_classes: int = None, ignore_bg: bool = True) -> torch.Tensor:
    """Cross-domain covariance regularization (``dca_modules.py:108-133``):
    the source context detached, the gradient through ``t_feats`` only."""
    sp = _mean_prob(s_preds1, s_preds2).detach()
    tp = _mean_prob(t_preds1, t_preds2).detach()
    gb = sp.shape[0] * mesh.world_size()
    cs = _batch_mean(get_context(sp, s_feats.detach(), ignore_bg), gb)
    ct = _batch_mean(get_context(tp, t_feats, ignore_bg), gb)
    return _regularize(_corrcoef_rows(cs, ct))


def mse_intra(preds1, preds2, feats, ignore_bg: bool = True) -> torch.Tensor:
    """(``dca_modules.py:136-159``) the mean squared difference of the
    halves' contexts."""
    probs = _mean_prob(preds1, preds2).detach()
    if mesh.world_size() > 1:   # the halves of the global batch
        probs, feats = mesh.gather_rows(probs), mesh.gather_rows(feats)
    b = probs.shape[0]
    c1 = get_context(probs[:b // 2], feats[:b // 2], ignore_bg)
    c2 = get_context(probs[b // 2:], feats[b // 2:], ignore_bg)
    return ((c1 - c2) ** 2).mean()


def mse_cross(s_preds1, s_preds2, s_feats, t_preds1, t_preds2, t_feats,
              ignore_bg: bool = True) -> torch.Tensor:
    """(``dca_modules.py:162-188``) the mean squared difference of the
    source (detached) and target contexts."""
    sp = _mean_prob(s_preds1, s_preds2).detach()
    tp = _mean_prob(t_preds1, t_preds2).detach()
    cs = get_context(sp, s_feats.detach(), ignore_bg)
    ct = get_context(tp, t_feats, ignore_bg)
    return mesh.gmean((cs - ct) ** 2)
