"""Segmentation heads: PSP pyramid pooling (PPMBilinear) and DeepLab ASPP.

Port of ``uemda_tpu/models/heads.py`` (reference ``Encoder.py:8-84``), with
the reference's module names (``ppm.{i}.1`` conv, ``ppm.{i}.2`` BN,
``conv_last.{0,1,4}``, ``conv2d_list.{i}``) so its state dicts load as they
are.

* ``PPMBilinear``: adaptive-avg-pool at scales (1, 2, 3, 6) -> 1x1 conv 512
  -> BN -> ReLU -> bilinear upsample (align_corners=False,
  ``Encoder.py:48-51``) -> concat with the feature -> 3x3 conv 512 -> BN ->
  ReLU -> dropout(0.1) -> 1x1 classifier. The dropout is elementwise, as
  the JAX head's ``flax.linen.Dropout(0.1)`` (``uemda_tpu/models/heads.py:
  43``), which is the port's reference; the torch reference (semseg PPM)
  used ``nn.Dropout2d``, which zeroes whole channels.
* ``ASPPHead`` (reference ``Classifier_Module``): parallel 3x3 convs at
  dilations (6, 12, 18, 24) with bias, summed.
"""

from typing import Optional

import torch
import torch.nn as nn

from uemda_tpu_torch.models.config import PPMConfig
from uemda_tpu_torch.models.resnet import BatchNorm, bn_act, conv
from uemda_tpu_torch.ops.resize import adaptive_avg_pool, resize_bilinear


class AdaptivePool(nn.Module):
    """Adaptive average pool to (scale, scale) through the separable pooling
    matrices (``ops/resize.adaptive_avg_pool``); holds no parameters."""

    def __init__(self, scale: int):
        super().__init__()
        self.scale = scale

    def forward(self, x):
        return adaptive_avg_pool(x, self.scale)


class Dropout(nn.Module):
    """Elementwise dropout, as ``flax.linen.Dropout``: in train mode keep
    each element with probability ``1 - rate`` and scale the kept ones by
    ``1 / (1 - rate)``. The keep mask is drawn from the caller's
    ``generator`` (on the activation's device), or injected as ``mask``
    (bool, True = keep, the activation's shape) so that tests can feed the
    JAX mask. Identity in eval mode."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        keep = 1.0 - self.rate
        if mask is None:
            mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
        elif tuple(mask.shape) != tuple(x.shape):
            raise ValueError(f"dropout mask {tuple(mask.shape)} does not "
                             f"match the activation {tuple(x.shape)}")
        mask = mask.to(device=x.device, dtype=torch.bool)
        return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype,
                                                       device=x.device))


class PPMBilinear(nn.Module):
    def __init__(self, cfg: PPMConfig):
        super().__init__()
        self.pool_scales = tuple(cfg.pool_scales)
        self.ppm = nn.ModuleList([
            nn.Sequential(AdaptivePool(s), conv(cfg.fc_dim, 512, 1),
                          BatchNorm(512), nn.ReLU())
            for s in self.pool_scales
        ])
        self.conv_last = nn.Sequential(
            conv(cfg.fc_dim + 512 * len(self.pool_scales), 512, 3),
            BatchNorm(512), nn.ReLU(), Dropout(0.1),
            nn.Conv2d(512, cfg.num_classes, 1, bias=True),
        )

    def forward(self, feat, generator: Optional[torch.Generator] = None,
                dropout_mask: Optional[torch.Tensor] = None):
        """``generator``/``dropout_mask`` feed the train-mode dropout."""
        h, w = feat.shape[2], feat.shape[3]
        # each branch: pool, 1x1 conv, BatchNorm + ReLU (bn_act)
        outs = [feat] + [resize_bilinear(bn_act(m[2], m[1](m[0](feat))), (h, w),
                                         align_corners=False)
                         for m in self.ppm]
        x = torch.cat(outs, dim=1).contiguous(memory_format=torch.channels_last)
        last = self.conv_last
        x = bn_act(last[1], last[0](x))
        return last[4](last[3](x, generator, dropout_mask))


class ASPPHead(nn.Module):
    """Reference ``Classifier_Module``: summed parallel dilated convs."""

    def __init__(self, fc_dim: int, num_classes: int,
                 dilations=(6, 12, 18, 24)):
        super().__init__()
        self.conv2d_list = nn.ModuleList([
            nn.Conv2d(fc_dim, num_classes, 3, padding=d, dilation=d, bias=True)
            for d in dilations
        ])

    def forward(self, feat, generator=None, dropout_mask=None):
        """The ASPP head has no dropout; the arguments are accepted for a
        uniform head call."""
        out = None
        for m in self.conv2d_list:
            y = m(feat)
            out = y if out is None else out + y
        return out
