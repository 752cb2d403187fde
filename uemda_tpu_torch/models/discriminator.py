"""Adversarial-DA discriminators and the MMD baseline model.

The port's copy of ``uemda_tpu/models/discriminator.py`` (reference
``uemda/models/Discriminator.py:4-78``, ``uemda/models/Deeplabv2_MMD.py:
8-56``): four-layer 4x4 stride-2 patch discriminators, a pixel
discriminator, the GAP reduction head and the MMD variant of DeepLab-v2.
Flax's 4x4/s2 convs with padding ((1, 1), (1, 1)) are ``nn.Conv2d(k=4,
s=2, p=1)``; each hidden conv is followed by LeakyReLU 0.2. NCHW in, NCHW
out. The convs are library (cuDNN) convs on the card, as they were XLA
convs in JAX.

Two functions share a name: this module's :func:`mmd_linear` is
``||mean(f_s) - mean(f_t)||^2``, ``alignment/mmd.py``'s divides it by the
feature width. Both are kept, as in the JAX package.
"""

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from uemda_tpu_torch.models.config import BackboneConfig
from uemda_tpu_torch.models.deeplabv2 import init_weights
from uemda_tpu_torch.models.heads import ASPPHead
from uemda_tpu_torch.models.resnet import ResNetEncoder
from uemda_tpu_torch.ops.resize import resize_bilinear
from uemda_tpu_torch.parallel.mesh import global_batch
from uemda_tpu_torch.utils.runtime import resolve_device


@torch.no_grad()
def lecun_init(module: nn.Module,
               generator: Optional[torch.Generator] = None) -> None:
    """Flax's default initializers on every conv and linear layer of
    ``module``: LeCun-normal weights (variance 1 / fan-in, truncated at two
    standard deviations) and zero biases."""
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            fan_in = m.weight[0].numel()
            # flax's truncated normal keeps the variance: std / 0.8796...
            std = math.sqrt(1.0 / fan_in) / .87962566103423978
            nn.init.trunc_normal_(m.weight, 0.0, std, -2 * std, 2 * std,
                                  generator=generator)
            if m.bias is not None:
                m.bias.zero_()


def _conv4x4(cin: int, cout: int) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, 4, stride=2, padding=1)


class _Patch(nn.Module):
    """The patch discriminators' trunk: 4x4/s2 convs of ``ndf`` x ``mults``
    channels, each followed by LeakyReLU 0.2, then a 4x4/s2 conv to one
    channel."""

    def __init__(self, in_channels: int, ndf: int, mults, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        chans = [in_channels] + [ndf * m for m in mults]
        self.convs = nn.ModuleList(_conv4x4(a, b)
                                   for a, b in zip(chans, chans[1:]))
        self.classifier = _conv4x4(chans[-1], 1)
        lecun_init(self, generator)
        self.to(resolve_device(device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for conv in self.convs:
            x = F.leaky_relu(conv(x), 0.2)
        return self.classifier(x)


class FCDiscriminator(_Patch):
    """(``Discriminator.py:4-28``) (B, C, H, W) class maps -> (B, 1, H/32,
    W/32) logits."""

    def __init__(self, num_classes: int, ndf: int = 64, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(num_classes, ndf, (1, 2, 4, 8), device, generator)


class FCDiscriminatorLocal(_Patch):
    """(``Discriminator.py:31-57``) three conv blocks and the classifier,
    then a x32 bilinear upsample (``align_corners=False``) back to
    (B, 1, H, W)."""

    def __init__(self, num_classes: int, ndf: int = 64, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(num_classes, ndf, (1, 2, 4), device, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = super().forward(x)
        return resize_bilinear(x, (x.shape[2] * 32, x.shape[3] * 32),
                               align_corners=False)


class PixelDiscriminator(nn.Module):
    """(``Discriminator.py:60-78``) 3x3 convs of ``ndf`` and ``ndf / 2``
    channels, then a source and a target 3x3 classifier, concatenated on
    the channel axis: (B, 2 num_classes, H, W)."""

    def __init__(self, in_channels: int, ndf: int = 512, num_classes: int = 1,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.conv1 = nn.Conv2d(in_channels, ndf, 3, padding=1)
        self.conv2 = nn.Conv2d(ndf, ndf // 2, 3, padding=1)
        self.src = nn.Conv2d(ndf // 2, num_classes, 3, padding=1)
        self.tgt = nn.Conv2d(ndf // 2, num_classes, 3, padding=1)
        lecun_init(self, generator)
        self.to(resolve_device(device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.leaky_relu(self.conv1(x), 0.2)
        x = F.leaky_relu(self.conv2(x), 0.2)
        return torch.cat([self.src(x), self.tgt(x)], dim=1)


class ReductionLayer(nn.Module):
    """Global average pool and a two-layer ReLU MLP to ``inplanes / 8``
    (``Deeplabv2_MMD.py:8-23``): (B, K, h, w) -> (B, K / 8)."""

    def __init__(self, inplanes: int = 2048):
        super().__init__()
        self.fc1 = nn.Linear(inplanes, inplanes // 4)
        self.fc2 = nn.Linear(inplanes // 4, inplanes // 8)

    def forward(self, feat: torch.Tensor) -> torch.Tensor:
        x = feat.mean(dim=(2, 3))
        return F.relu(self.fc2(F.relu(self.fc1(x))))


class DeeplabV2MMD(nn.Module):
    """The MMD baseline (``Deeplabv2_MMD.py:26-43``): the ResNet encoder's
    last feature, one ASPP head and the reduction. Train mode (``.train()``)
    returns (logits upsampled to the input with ``align_corners=True``, the
    reduced feature); eval mode the softmax of those logits."""

    def __init__(self, backbone: BackboneConfig = BackboneConfig(),
                 num_classes: int = 7, inchannels: int = 2048, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.encoder = ResNetEncoder(backbone)
        self.reduction = ReductionLayer(inchannels)
        self.cls_pred = ASPPHead(inchannels, num_classes)
        init_weights(self, generator)   # the trunk's and the ASPP head's
        lecun_init(self.reduction, generator)
        self.to(device=resolve_device(device),
                memory_format=torch.channels_last)
        self.eval()

    def forward(self, x: torch.Tensor):
        hw = (x.shape[2], x.shape[3])
        feat = self.encoder(x.contiguous(memory_format=torch.channels_last))[-1]
        reduced = self.reduction(feat)
        logits = resize_bilinear(self.cls_pred(feat), hw, align_corners=True)
        if self.training:
            return logits, reduced
        return torch.softmax(logits, dim=1)


@global_batch("f_s", "f_t")
def mmd_linear(f_s: torch.Tensor, f_t: torch.Tensor) -> torch.Tensor:
    """Linear-kernel MMD between reduced features, as this baseline uses
    it: ``||mean(f_s) - mean(f_t)||^2`` (of the gathered global batch
    under data parallelism)."""
    delta = f_s.mean(dim=0) - f_t.mean(dim=0)
    return (delta * delta).sum()
