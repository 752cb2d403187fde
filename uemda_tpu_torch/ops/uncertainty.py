"""Pixel-entropy uncertainty and the UVEM valuable-example weight curve.

The port's copy of ``uemda_tpu/ops/uncertainty.py`` (reference
``uemda/gast/balance.py:345-423``)::

    u = -sum_c p_c * log(max(p_c, 1e-30))      entropy of the soft label
    w(u) = clamp(-1/m^2     * (u - m)^2 + 1, 0, 1) ^ (1/gamma)   u <= m
         = clamp(-1/(t-m)^2 * (u - m)^2 + 1, 0, 1) ^ (1/gamma)   m < u < t
         = 0                                                      u >= t

The guard keeps p = 0 (stored fp16 pseudo labels hold exact zeros) at a
zero contribution; a NaN probability stays NaN. These are the plain
versions the K8 wrapper (``ops/mine.py``) is held against: every constant
is a Python double rounded once to f32 by the operation, as in JAX, and the
entropy sums its class terms one after the other from 0, the order K8
takes. Near u = t the weight's slope is unbounded (w ~ (t - u)^(1/gamma)),
so two entropies a rounding apart can give weights far more than 1e-5
apart there: the kernel matches this version bit for bit on the card
because both sum in one order with the same ``logf``.
"""

import torch


def pixel_entropy(probs: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """u = -sum p log max(p, 1e-30) over ``dim`` (the class axis of the
    port's (B, C, H, W)), in f32, summed class by class in order."""
    p = probs.float()
    terms = p * torch.log(torch.clamp_min(p, 1e-30))
    acc = torch.zeros_like(terms.select(dim, 0))
    for c in range(terms.shape[dim]):
        acc = acc + terms.select(dim, c)
    return -acc


def uvem_weight(u: torch.Tensor, m: float = 0.2, threshold: float = 0.7,
                gamma: float = 4.0) -> torch.Tensor:
    """The piecewise-parabola weight (``balance.py:396-423``), with both
    degenerate branches: ``m <= 0`` has no left parabola (weight 1 there),
    ``m >= threshold`` no right one (weight 0). A NaN ``u`` takes the right
    branch at x = 0, as the JAX selects give."""
    u = u.float()
    if m > 0:
        left = torch.clamp(-1.0 / (m * m) * (u - m) ** 2 + 1.0, 0.0, 1.0)
        left = left ** (1.0 / gamma)
    else:
        left = torch.ones_like(u)
    if m < threshold:
        x = torch.where((u > m) & (u <= threshold), u, torch.zeros_like(u))
        right = torch.clamp(-1.0 / ((threshold - m) ** 2) * (x - m) ** 2 + 1.0,
                            0.0, 1.0)
        right = right ** (1.0 / gamma)
    else:
        right = torch.zeros_like(u)
    w = torch.where(u <= m, left, right)
    return torch.where(u >= threshold, torch.zeros_like(w), w)
