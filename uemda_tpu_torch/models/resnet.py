"""ResNet backbone zoo and segmentation encoder.

Port of ``uemda_tpu/models/resnet.py`` (reference ``uemda/_resnets.py:32-344``
and ``uemda/resnet.py:44-207``): ResNet-18/34/50/101/152, ResNeXt-50/101
(grouped 3x3s of width ``int(planes * base_width / 64) * groups``) and the
v1c deep stem (three 3x3 convs, ``stem``). Module names follow torchvision
(``stem.{0,1,3,4,6,7}`` for the v1c stem), so the reference's
``encoder.resnet.*`` state-dict keys load as they are.

* Output-stride surgery (``resnet.py:192-207``) is computed up front by
  :func:`stage_plan`: the 3x3 that carried the stride keeps ``dilate // 2``,
  every other 3x3 of the stage gets the full ``dilate`` -- including conv2
  of the first BasicBlock.
* :class:`BatchNorm` (``models/resnet.py:59-78``) computes in f32 and
  returns the input dtype. In eval mode, or when ``frozen``, it uses the
  running statistics; in train mode it normalizes with the batch statistics
  and updates the running ones as flax does, with the *biased* batch
  variance.

* Per-stage gradient checkpointing (``with_cp``, ``resnet.py:146-165``):
  in train mode with gradients on, each flagged stage runs under
  ``torch.utils.checkpoint`` (non-reentrant), as ``nn.remat`` does: its
  activations are recomputed in the backward. The recompute must not move
  the BatchNorm running statistics a second time (flax throws the
  recompute's mutations away), so it runs under :func:`_recomputing`,
  which :class:`BatchNorm` reads.
"""

import contextlib
from typing import List, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
import torch.utils.checkpoint

from uemda_tpu_torch.models.config import BackboneConfig
from uemda_tpu_torch.parallel import mesh


# > 0 while a checkpointed stage is recomputed for the backward: BatchNorm
# then normalizes as in the forward and leaves its running statistics alone.
# A counter, not a thread-local: the recompute runs on the autograd
# engine's thread, not the one that started the forward.
_RECOMPUTE = [0]


@contextlib.contextmanager
def _recomputing():
    _RECOMPUTE[0] += 1
    try:
        yield
    finally:
        _RECOMPUTE[0] -= 1


def _checkpoint_contexts():
    """``context_fn`` of the checkpointed stages: nothing in the forward,
    :func:`_recomputing` in the recompute."""
    return contextlib.nullcontext(), _recomputing()


def conv(cin: int, cout: int, kernel: int, stride: int = 1, dilation: int = 1,
         groups: int = 1, bias: bool = False) -> nn.Conv2d:
    """Conv with explicit torch-style symmetric padding."""
    pad = dilation * (kernel - 1) // 2
    return nn.Conv2d(cin, cout, kernel, stride, pad, dilation, groups,
                     bias=bias)


class BatchNorm(nn.BatchNorm2d):
    """BatchNorm (eps 1e-5, torch momentum 0.1 = flax 0.9) whose statistics
    are f32 whatever the activation dtype; returns the input dtype.

    Eval mode, or ``frozen`` (``batchnorm_trainable=False``, the reference's
    BN-eval trick): the running statistics, never updated. Train mode: the
    batch statistics, and the running ones move to
    ``0.9 * running + 0.1 * batch`` with the *biased* batch variance, as
    flax puts it (``flax/linen/normalization.py:401-404``).
    ``F.batch_norm(training=True)`` would put in the unbiased one -- 8/7 of
    it at the PPM's 1x1 pool with batch 8 -- so the library call here only
    writes the batch statistics (momentum 1.0 into scratch buffers) and the
    update is computed below. The affine parameters are used in f32 even
    when the caller hands in a bf16 copy: flax's BatchNorm(dtype=f32) takes
    the bf16-rounded values in f32 too. Under data parallelism (world size
    > 1) train mode normalizes with the global batch's statistics
    (``parallel/mesh.py: batch_norm``), and the running ones move as one
    rank's at the global batch would."""

    def __init__(self, num_features: int, frozen: bool = False):
        super().__init__(num_features, eps=1e-5, momentum=0.1)
        self.frozen = frozen

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w, b = self.weight.float(), self.bias.float()
        if not self.training or self.frozen:
            y = F.batch_norm(x.float(), self.running_mean.float(),
                             self.running_var.float(), w, b, False, 0.0,
                             self.eps)
            return y.to(x.dtype)
        if mesh.world_size() > 1:
            # the global batch's statistics (parallel/mesh.py)
            y, batch_mean, biased = mesh.batch_norm(x, w, b, self.eps)
            if not _RECOMPUTE[0]:
                with torch.no_grad():
                    self.running_mean.mul_(0.9).add_(0.1 * batch_mean)
                    self.running_var.mul_(0.9).add_(0.1 * biased)
            return y
        c = x.shape[1]
        # zeros, not empty: the library scales the old value by 1 - 1.0,
        # and 0 * NaN garbage would stay NaN
        batch_mean = torch.zeros(c, dtype=torch.float32, device=x.device)
        batch_var = torch.zeros_like(batch_mean)  # unbiased, as torch writes it
        xin = x if x.dtype == torch.bfloat16 and x.is_cuda else x.float()
        y = F.batch_norm(xin, batch_mean, batch_var, w, b, True, 1.0, self.eps)
        n = x.numel() // c
        if not _RECOMPUTE[0]:
            with torch.no_grad():
                biased = batch_var * ((n - 1) / n)
                self.running_mean.mul_(0.9).add_(0.1 * batch_mean)
                self.running_var.mul_(0.9).add_(0.1 * biased)
        return y.to(x.dtype)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, inp: int, planes: int, stride: int = 1,
                 dilation: int = 1, dilation2: int = 1,
                 downsample: bool = False, frozen_bn: bool = False,
                 groups: int = 1, base_width: int = 64):
        super().__init__()
        if groups != 1 or base_width != 64:
            raise ValueError("BasicBlock takes groups 1 and base_width 64")
        self.conv1 = conv(inp, planes, 3, stride, dilation)
        self.bn1 = BatchNorm(planes, frozen_bn)
        self.conv2 = conv(planes, planes, 3, 1, dilation2)
        self.bn2 = BatchNorm(planes, frozen_bn)
        self.downsample = nn.Sequential(
            conv(inp, planes, 1, stride), BatchNorm(planes, frozen_bn)
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
                 downsample: bool = False, frozen_bn: bool = False,
                 groups: int = 1, base_width: int = 64):
        super().__init__()
        width = int(planes * (base_width / 64.0)) * groups
        out_ch = planes * self.expansion
        self.conv1 = conv(inp, width, 1)
        self.bn1 = BatchNorm(width, frozen_bn)
        # stride lives on conv2 (torchvision v1.5, _resnets.py:84)
        self.conv2 = conv(width, width, 3, stride, dilation, groups)
        self.bn2 = BatchNorm(width, frozen_bn)
        self.conv3 = conv(width, out_ch, 1)
        self.bn3 = BatchNorm(out_ch, frozen_bn)
        self.downsample = nn.Sequential(
            conv(inp, out_ch, 1, stride), BatchNorm(out_ch, frozen_bn)
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


class ResNet(nn.Module):
    """torchvision-named trunk: conv1, bn1 (or the v1c ``stem``),
    layer1..layer4."""

    def __init__(self, cfg: BackboneConfig):
        super().__init__()
        if cfg.resnet_type not in RESNET_SPECS:
            raise KeyError(f"unknown resnet_type {cfg.resnet_type!r}")
        block_cls, layers, groups, base_width, deep_stem = RESNET_SPECS[
            cfg.resnet_type]
        self.output_stride = cfg.output_stride
        self.with_cp = tuple(cfg.with_cp)
        self.deep_stem = deep_stem
        frozen_bn = not cfg.batchnorm_trainable
        if deep_stem:
            # v1c (resnet.py:233-237): 3x3/s2 3->32, 3x3 32->32, 3x3 32->64
            mods, cin = [], 3
            for ch, st in ((32, 2), (32, 1), (64, 1)):
                mods += [conv(cin, ch, 3, st), BatchNorm(ch, frozen_bn),
                         nn.ReLU()]
                cin = ch
            self.stem = nn.Sequential(*mods)
        else:
            self.conv1 = conv(3, 64, 7, 2)
            self.bn1 = BatchNorm(64, frozen_bn)
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
                    frozen_bn=frozen_bn, groups=groups,
                    base_width=base_width,
                ))
                in_ch = planes[si] * block_cls.expansion
            self.add_module(f"layer{si + 1}", nn.Sequential(*blocks))

    def forward(self, x) -> List[torch.Tensor]:
        x = self.stem(x) if self.deep_stem else F.relu(self.bn1(self.conv1(x)))
        x = _max_pool_3x3_s2(x)
        outs = []
        for si in range(self.num_stages):
            layer = getattr(self, f"layer{si + 1}")
            if (self.with_cp[si] and self.training
                    and torch.is_grad_enabled()):
                x = _checkpointed(layer, x)
            else:
                x = layer(x)
            outs.append(x)
        return outs


def _checkpointed(layer: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """``layer(x)`` with its activations recomputed in the backward. The
    stage's tensors are taken now: under ``torch.func.functional_call``
    (the train step's compute copy of the masters, scratch BatchNorm
    buffers) they are the swapped-in ones, which the module no longer
    holds when the backward recomputes."""
    tensors = dict(layer.named_parameters())
    tensors.update(layer.named_buffers())

    def run(inp):
        return torch.func.functional_call(layer, tensors, (inp,))

    return torch.utils.checkpoint.checkpoint(
        run, x, use_reentrant=False, context_fn=_checkpoint_contexts)


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
