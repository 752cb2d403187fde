"""ResNet backbone and segmentation encoder, eval mode.

Port of ``uemda_tpu/models/resnet.py`` (reference ``uemda/_resnets.py:32-344``
and ``uemda/resnet.py:44-207``). Module names follow torchvision, so the
reference's ``encoder.resnet.*`` state-dict keys load as they are.

* Output-stride surgery (``resnet.py:192-207``) is computed up front by
  :func:`stage_plan`: the 3x3 that carried the stride keeps ``dilate // 2``,
  every other 3x3 of the stage gets the full ``dilate`` -- including conv2
  of the first BasicBlock.
* :class:`BatchNorm` always uses the running statistics, in f32, and returns
  the input dtype (``models/resnet.py:59-78``); training comes in a later
  slice.

ResNeXt and the v1c deep-stem variants raise ``NotImplementedError``.
"""

from typing import List, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from uemda_tpu_torch.models.config import BackboneConfig


def conv(cin: int, cout: int, kernel: int, stride: int = 1, dilation: int = 1,
         groups: int = 1, bias: bool = False) -> nn.Conv2d:
    """Conv with explicit torch-style symmetric padding."""
    pad = dilation * (kernel - 1) // 2
    return nn.Conv2d(cin, cout, kernel, stride, pad, dilation, groups,
                     bias=bias)


class BatchNorm(nn.BatchNorm2d):
    """Eval-mode BatchNorm (eps 1e-5) from the running statistics, computed
    in f32 whatever the activation dtype; returns the input dtype."""

    def __init__(self, num_features: int):
        super().__init__(num_features, eps=1e-5, momentum=0.1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.batch_norm(x.float(), self.running_mean.float(),
                         self.running_var.float(), self.weight.float(),
                         self.bias.float(), False, 0.0, self.eps)
        return y.to(x.dtype)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, inp: int, planes: int, stride: int = 1,
                 dilation: int = 1, dilation2: int = 1,
                 downsample: bool = False):
        super().__init__()
        self.conv1 = conv(inp, planes, 3, stride, dilation)
        self.bn1 = BatchNorm(planes)
        self.conv2 = conv(planes, planes, 3, 1, dilation2)
        self.bn2 = BatchNorm(planes)
        self.downsample = nn.Sequential(
            conv(inp, planes, 1, stride), BatchNorm(planes)
        ) if downsample else None

    def forward(self, x):
        identity = x if self.downsample is None else self.downsample(x)
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        return F.relu(out + identity)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, inp: int, planes: int, stride: int = 1,
                 dilation: int = 1, dilation2: int = 1,
                 downsample: bool = False):
        super().__init__()
        out_ch = planes * self.expansion
        self.conv1 = conv(inp, planes, 1)
        self.bn1 = BatchNorm(planes)
        # stride lives on conv2 (torchvision v1.5, _resnets.py:84)
        self.conv2 = conv(planes, planes, 3, stride, dilation)
        self.bn2 = BatchNorm(planes)
        self.conv3 = conv(planes, out_ch, 1)
        self.bn3 = BatchNorm(out_ch)
        self.downsample = nn.Sequential(
            conv(inp, out_ch, 1, stride), BatchNorm(out_ch)
        ) if downsample else None

    def forward(self, x):
        identity = x if self.downsample is None else self.downsample(x)
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        return F.relu(out + identity)


RESNET_SPECS = {
    # name: (block, layers, groups, width_per_group, deep_stem)
    "resnet18": (BasicBlock, (2, 2, 2, 2), 1, 64, False),
    "resnet34": (BasicBlock, (3, 4, 6, 3), 1, 64, False),
    "resnet50": (Bottleneck, (3, 4, 6, 3), 1, 64, False),
    "resnet101": (Bottleneck, (3, 4, 23, 3), 1, 64, False),
    "resnet152": (Bottleneck, (3, 8, 36, 3), 1, 64, False),
    "resnext50_32x4d": (Bottleneck, (3, 4, 6, 3), 32, 4, False),
    "resnext101_32x4d": (Bottleneck, (3, 4, 23, 3), 32, 4, False),
    "resnext101_32x8d": (Bottleneck, (3, 4, 23, 3), 32, 8, False),
    "resnet50_v1c": (Bottleneck, (3, 4, 6, 3), 1, 64, True),
    "resnet101_v1c": (Bottleneck, (3, 4, 23, 3), 1, 64, True),
}


def stage_plan(output_stride: int) -> Sequence[Tuple[int, int]]:
    """(stride, dilate) per stage for layers 1-4 (``resnet.py:62-66,
    192-207``): dilate > 1 gives the first block's 3x3 dilate//2 and the
    later blocks dilate."""
    if output_stride == 32:
        return [(1, 1), (2, 1), (2, 1), (2, 1)]
    if output_stride == 16:
        return [(1, 1), (2, 1), (2, 1), (1, 2)]
    return [(1, 1), (2, 1), (1, 2), (1, 4)]  # OS 8


def _max_pool_3x3_s2(x: torch.Tensor) -> torch.Tensor:
    """torch MaxPool2d(kernel=3, stride=2, padding=1)."""
    return F.max_pool2d(x, 3, 2, 1)


def check_supported(resnet_type: str) -> None:
    if resnet_type not in RESNET_SPECS:
        raise KeyError(f"unknown resnet_type {resnet_type!r}")
    _, _, groups, _, deep_stem = RESNET_SPECS[resnet_type]
    if groups != 1 or deep_stem:
        raise NotImplementedError(
            f"{resnet_type}: ResNeXt and v1c deep-stem backbones are not "
            "ported yet (ROADMAP.md queue A)")


class ResNet(nn.Module):
    """torchvision-named trunk: conv1, bn1, layer1..layer4."""

    def __init__(self, cfg: BackboneConfig):
        super().__init__()
        check_supported(cfg.resnet_type)
        block_cls, layers, _, _, _ = RESNET_SPECS[cfg.resnet_type]
        self.output_stride = cfg.output_stride
        self.conv1 = conv(3, 64, 7, 2)
        self.bn1 = BatchNorm(64)
        plan = stage_plan(cfg.output_stride)
        planes = (64, 128, 256, 512)
        in_ch = 64
        self.num_stages = 4 if cfg.include_conv5 else 3
        for si in range(self.num_stages):
            stride, dilate = plan[si]
            blocks = []
            for bi in range(layers[si]):
                first = bi == 0
                blocks.append(block_cls(
                    in_ch, planes[si],
                    stride=stride if first else 1,
                    dilation=max(dilate // 2, 1) if first else dilate,
                    dilation2=dilate,
                    downsample=first and (
                        stride != 1 or in_ch != planes[si] * block_cls.expansion
                    ),
                ))
                in_ch = planes[si] * block_cls.expansion
            self.add_module(f"layer{si + 1}", nn.Sequential(*blocks))

    def forward(self, x) -> List[torch.Tensor]:
        x = _max_pool_3x3_s2(F.relu(self.bn1(self.conv1(x))))
        outs = []
        for si in range(self.num_stages):
            x = getattr(self, f"layer{si + 1}")(x)
            outs.append(x)
        return outs


class ResNetEncoder(nn.Module):
    """Backbone encoder returning the [c2, c3, c4, c5] pyramid
    (``uemda/resnet.py:140-168``); the trunk sits under ``resnet``."""

    def __init__(self, cfg: BackboneConfig):
        super().__init__()
        self.resnet = ResNet(cfg)

    def forward(self, x) -> List[torch.Tensor]:
        return self.resnet(x)

    @staticmethod
    def out_channels(resnet_type: str) -> int:
        return 512 * RESNET_SPECS[resnet_type][0].expansion
