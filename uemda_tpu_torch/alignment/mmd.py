"""MMD losses, linear and multi-kernel RBF.

The port's copy of ``uemda_tpu/alignment/mmd.py`` (reference
``uemda/gast/mmd.py:15-58``), the criterion of the DeepLab-v2 MMD baseline:
the linear form and a sum of Gaussian kernels over ``kernel_num``
bandwidths around the mean pairwise squared distance, which is detached
from the graph as in JAX. The all-pairs distances are one (N + M)^2 GEMM,
in full f32 as JAX pins ``Precision.HIGHEST``.

This module's :func:`mmd_linear` divides by the feature width;
``models/discriminator.py``'s does not. Both are kept, as in JAX. Under
data parallelism both run on the gathered global batch.
"""

import torch

from uemda_tpu_torch.parallel.mesh import global_batch
from uemda_tpu_torch.utils.runtime import require_full_f32


@global_batch("f_x", "f_y")
def mmd_linear(f_x: torch.Tensor, f_y: torch.Tensor) -> torch.Tensor:
    """(``mmd.py:41-45``) ``||mean_x - mean_y||^2 / d`` in f32."""
    delta = f_x.float().mean(0) - f_y.float().mean(0)
    return (delta @ delta) / delta.shape[0]


@global_batch("source", "target")
def mmd_rbf(source: torch.Tensor, target: torch.Tensor,
            kernel_mul: float = 2.0, kernel_num: int = 5,
            fix_sigma: float = None) -> torch.Tensor:
    """(``mmd.py:24-58``) ``xx + yy - xy - yx`` of the summed kernels
    ``exp(-d2 / (bw mul^i))``, ``bw`` the mean off-diagonal squared
    distance (or ``fix_sigma``) over ``mul^(kernel_num // 2)``."""
    require_full_f32("mmd_rbf")
    n = source.shape[0]
    total = torch.cat([source, target], dim=0).float()
    sq = (total * total).sum(-1)
    l2 = (sq[:, None] + sq[None, :] - 2.0 * (total @ total.T)).clamp(min=0.0)
    m = total.shape[0]
    if fix_sigma:
        bandwidth = torch.tensor(float(fix_sigma), device=total.device)
    else:
        bandwidth = l2.detach().sum() / (m * m - m)
    bandwidth = bandwidth / (kernel_mul ** (kernel_num // 2))
    kernels = sum(torch.exp(-l2 / (bandwidth * kernel_mul ** i))
                  for i in range(kernel_num))
    return (kernels[:n, :n].mean() + kernels[n:, n:].mean()
            - kernels[:n, n:].mean() - kernels[n:, :n].mean())
