"""SpixelNet (SIN): a learned superpixel affinity CNN.

The port's copy of ``uemda_tpu/superpixels/spixelnet.py`` (reference
``uemda/gast/sin/spixel_deconv.py:13-143``, dormant there): an
encoder-decoder that predicts, per pixel, a softmax over the 9 neighbouring
grid cells (``assign_ch = 9``), the soft pixel-to-superpixel assignment of
"Superpixel Segmentation with Fully Convolutional Networks" (CVPR 2020).
As in the JAX package, each "deconv" is a bilinear resize
(align_corners=False) followed by a 3x3 conv. NCHW in logical order,
channels_last in memory. Weights come across from flax through
``models/port.py: spixelnet_state_dict_from_jax``.
"""

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from uemda_tpu_torch.ops.resize import resize_bilinear
from uemda_tpu_torch.utils.runtime import resolve_device

WIDTHS = (16, 32, 64, 128, 256)


def _conv(cin: int, cout: int, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, 3, stride=stride, padding=1)


class ConvBNRelu(nn.Module):
    """3x3 conv (bias), BatchNorm (flax's momentum 0.9 is torch's 0.1),
    LeakyReLU 0.1."""

    def __init__(self, cin: int, cout: int, stride: int = 1):
        super().__init__()
        self.conv = _conv(cin, cout, stride)
        self.bn = nn.BatchNorm2d(cout, eps=1e-5, momentum=0.1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.leaky_relu(self.bn(self.conv(x)), 0.1)


class SpixelNet(nn.Module):
    """(B, 3, H, W) -> (B, ``assign_ch``, H, W) softmax assignment maps.
    ``device=None`` means the card; ``generator`` draws the init (flax's
    ``variance_scaling(0.02, "fan_in", "normal")`` convs, zero biases,
    identity BatchNorm). Train mode (``model.train()``) normalizes with
    batch statistics, as flax's ``train=True``."""

    def __init__(self, assign_ch: int = 9, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        cin = 3
        for i, w in enumerate(WIDTHS):
            setattr(self, f"conv{i}a", ConvBNRelu(cin, w, 1 if i == 0 else 2))
            setattr(self, f"conv{i}b", ConvBNRelu(w, w))
            cin = w
        for i in range(len(WIDTHS) - 2, -1, -1):
            setattr(self, f"deconv{i}", _conv(WIDTHS[i + 1], WIDTHS[i]))
            setattr(self, f"up{i}", ConvBNRelu(2 * WIDTHS[i], WIDTHS[i]))
        self.pred = _conv(WIDTHS[0], assign_ch)
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, nn.Conv2d):
                    std = math.sqrt(0.02 / m.weight[0].numel())
                    m.weight.normal_(0.0, std, generator=generator)
                    m.bias.zero_()
        self.to(device=resolve_device(device),
                memory_format=torch.channels_last)
        self.eval()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        feats = x.contiguous(memory_format=torch.channels_last)
        skips = []
        for i in range(len(WIDTHS)):
            feats = getattr(self, f"conv{i}a")(feats)
            feats = getattr(self, f"conv{i}b")(feats)
            skips.append(feats)
        out = feats
        for i in range(len(WIDTHS) - 2, -1, -1):
            hw = skips[i].shape[2:]
            out = resize_bilinear(out, hw, align_corners=False)
            out = F.leaky_relu(getattr(self, f"deconv{i}")(out), 0.1)
            out = torch.cat([out, skips[i]], dim=1)
            out = getattr(self, f"up{i}")(out)
        return torch.softmax(self.pred(out), dim=1).contiguous(
            memory_format=torch.channels_last)
