"""TransNorm: two-domain batch normalization with adaptive channel alphas.

The port's copy of ``uemda_tpu/models/trans_norm.py`` (reference
``uemda/trans_norm.py:8-230``, dormant there and kept for API parity). In
training the batch is the concatenation [source; target]: each half is
normalized with its own batch statistics but the shared affine, then scaled
by (1 + alpha), a channel attention from the distance between the domains'
normalized means. Eval normalizes with the *target* running statistics.

Statistics are f32 whatever the input dtype, and the result comes back in
the input dtype, as the port's ``BatchNorm``. The running statistics move
with torch's momentum convention, ``(1 - m) old + m batch``, and track the
unbiased batch variance, which alpha also reads, while the normalization
uses the biased one (``F.batch_norm``'s split, ``trans_norm.py:193-201``).
"""

import torch
import torch.nn as nn

from uemda_tpu_torch.parallel import mesh


class TransNorm2d(nn.Module):
    """Parameters ``weight`` (flax ``scale``, drawn from U[0, 1) as flax's
    ``uniform(1.0)``) and ``bias``; buffers ``mean_source``,
    ``mean_target``, ``var_source`` and ``var_target``, under the JAX
    package's names."""

    def __init__(self, num_features: int, eps: float = 1e-5,
                 momentum: float = 0.1, device=None, generator=None):
        super().__init__()
        c = num_features
        self.num_features, self.eps, self.momentum = c, eps, momentum
        self.weight = nn.Parameter(torch.rand(c, generator=generator))
        self.bias = nn.Parameter(torch.zeros(c))
        for dom in ("source", "target"):
            self.register_buffer(f"mean_{dom}", torch.zeros(c))
            self.register_buffer(f"var_{dom}", torch.ones(c))
        if device is not None:
            self.to(device)

    def _alpha(self, m_s, v_s, m_t, v_t) -> torch.Tensor:
        dis = (m_s * torch.rsqrt(v_s + self.eps)
               - m_t * torch.rsqrt(v_t + self.eps)).abs()
        prob = 1.0 / (1.0 + dis)
        return self.num_features * prob / prob.sum()

    def _bn(self, h, mean, var):
        shape = (1, -1, 1, 1)
        return ((h - mean.view(shape)) * torch.rsqrt(var + self.eps).view(shape)
                * self.weight.float().view(shape)
                + self.bias.float().view(shape))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        if not self.training:
            z = self._bn(xf, self.mean_target, self.var_target)
            alpha = self._alpha(self.mean_source, self.var_source,
                                self.mean_target, self.var_target)
            return (z * (1.0 + alpha.view(1, -1, 1, 1))).to(x.dtype)
        b = x.shape[0] // 2
        halves = (xf[:b], xf[b:])
        stats = []
        for h in halves:
            n = h.numel() // self.num_features
            if mesh.world_size() == 1:
                mean = h.mean(dim=(0, 2, 3))
                v_b = h.var(dim=(0, 2, 3), unbiased=False)
            else:
                # each rank's halves are its rows of the two domains: the
                # statistics of each domain's global batch, two-pass
                n = n * mesh.world_size()
                mean = mesh.gsum(h.sum(dim=(0, 2, 3))) / n
                dev = h - mean.view(1, -1, 1, 1)
                v_b = mesh.gsum((dev * dev).sum(dim=(0, 2, 3))) / n
            stats.append((mean, v_b, v_b * n / max(n - 1, 1)))
        (ms, vbs, vus), (mt, vbt, vut) = stats
        z = torch.cat([self._bn(halves[0], ms, vbs),
                       self._bn(halves[1], mt, vbt)], dim=0)
        with torch.no_grad():
            m = self.momentum
            for buf, new in ((self.mean_source, ms), (self.var_source, vus),
                             (self.mean_target, mt), (self.var_target, vut)):
                buf.mul_(1 - m).add_(m * new)
            alpha = self._alpha(ms, vus, mt, vut)
        return (z * (1.0 + alpha.view(1, -1, 1, 1))).to(x.dtype)
