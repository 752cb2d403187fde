"""Dual-head DeepLab-v2/PSP segmenter.

Port of ``uemda_tpu/models/deeplabv2.py`` (reference
``uemda/models/Encoder.py:87-186``): ResNet encoder (OS16) -> optional
affine-free instance norm on the last feature map (the K1 kernels) -> twin
heads (layer5/layer6, PPM or ASPP). In eval mode the result is the average
of the heads' softmax at input resolution with align_corners=True
(``Encoder.py:144-155``), computed by the K3 eval-tail kernel. In train mode
(``model.train()``, the JAX package's ``train=True``) it is the stride-16
logits and feature, ``(x1, x2, feat)`` (``deeplabv2.py:88-109``), with
batch-statistics BatchNorm and the heads' dropout. ``with_aux`` (eval
only, ``deeplabv2.py:64-111``) also returns the stride-16 head logits and
the feature, for the label-refinement tools. Cascade mode feeds c4 to
head1 and c5 to head2 (``Encoder.py:131-143``); single-head mode mirrors
``Encoder.py:156-165``.

Tensors are NCHW in logical order and channels_last in memory.
"""

import math
from typing import Dict, List, Optional

import torch
import torch.nn as nn

from uemda_tpu_torch.models.config import DeeplabV2Config, PPMConfig
from uemda_tpu_torch.models.heads import ASPPHead, PPMBilinear
from uemda_tpu_torch.models.resnet import RESNET_SPECS, ResNetEncoder
from uemda_tpu_torch.ops.insnorm import instance_norm
from uemda_tpu_torch.ops.tail import tail_upsample_softmax_mean
from uemda_tpu_torch.utils.runtime import resolve_device


def eval_tail(logits: List[torch.Tensor], out_hw) -> torch.Tensor:
    """Mean of the heads' softmax at ``out_hw``. Heads of one shape go
    through one K3 launch on their stacked logits; otherwise each head
    takes its own launch and the results are averaged."""
    if all(l.shape == logits[0].shape for l in logits):
        nc = logits[0].shape[1]
        cat = logits[0] if len(logits) == 1 else torch.cat(logits, dim=1)
        cat = cat.contiguous(memory_format=torch.channels_last)
        return tail_upsample_softmax_mean(cat, out_hw, len(logits), nc)
    probs = [tail_upsample_softmax_mean(
        l.contiguous(memory_format=torch.channels_last), out_hw, 1,
        l.shape[1]) for l in logits]
    return (sum(p.float() for p in probs) / len(probs)).to(logits[0].dtype)


class DeeplabV2(nn.Module):
    """``device=None`` means the card ("cuda"); the CPU runs only when the
    caller passes ``device="cpu"``. ``generator`` draws the random init
    (:func:`init_weights`); trained weights come through
    ``load_state_dict``."""

    def __init__(self, config: DeeplabV2Config, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        self.config = cfg = config
        self.encoder = ResNetEncoder(cfg.backbone)
        exp = RESNET_SPECS[cfg.backbone.resnet_type][0].expansion
        n_st = 4 if cfg.backbone.include_conv5 else 3
        chans = [p * exp for p in (64, 128, 256, 512)[:n_st]]
        if cfg.multi_layer:
            fc = (chans[-2], chans[-1]) if cfg.cascade else (chans[-1],) * 2
            self.layer5 = self._make_head(fc[0])
            self.layer6 = self._make_head(fc[1])
        else:
            self.cls_pred = self._make_head(chans[-1])
        init_weights(self, generator)
        self.to(device=device, memory_format=torch.channels_last)
        self.eval()

    def _make_head(self, fc_dim: int) -> nn.Module:
        cfg = self.config
        if cfg.use_ppm:
            return PPMBilinear(PPMConfig(
                num_classes=cfg.ppm.num_classes, fc_dim=fc_dim,
                use_aux=cfg.ppm.use_aux, pool_scales=cfg.ppm.pool_scales))
        return ASPPHead(fc_dim, cfg.num_classes, cfg.aspp_dilations)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                dropout_masks: Optional[Dict[str, torch.Tensor]] = None,
                with_aux: bool = False):
        """Eval mode: (B, 3, H, W) -> (B, nc, H, W) averaged head softmax;
        with ``with_aux``, ``(probs, x1, x2, feat)``: the stride-16 logits
        of both heads and the (instance-normed) feature, ``feat2`` in
        cascade mode, ``(probs, x1, x1, feat)`` with one head. Train mode
        ignores ``with_aux``, as JAX does.

        Train mode: ``(x1, x2, feat)``; cascade ``(x1, feat1, x2, feat2)``;
        one head ``(x1, feat)`` -- logits and features at stride 16. Each
        PPM head's dropout draws from ``generator`` (on x's device) unless
        ``dropout_masks[head name]`` (bool, True = keep, the shape of the
        head's 512-channel activation) is given."""
        cfg = self.config
        train = self.training
        masks = dropout_masks or {}
        in_hw = (x.shape[2], x.shape[3])
        x = x.contiguous(memory_format=torch.channels_last)
        pyramid = self.encoder(x)
        norm = instance_norm if cfg.is_ins_norm else (lambda t: t)

        def head(name, feat):
            return getattr(self, name)(feat, generator, masks.get(name))

        if cfg.multi_layer:
            if cfg.cascade:
                feat1, feat2 = norm(pyramid[-2]), norm(pyramid[-1])
                x1, x2 = head("layer5", feat1), head("layer6", feat2)
                if train:
                    return x1, feat1, x2, feat2
                feat = feat2
            else:
                feat = norm(pyramid[-1])
                x1, x2 = head("layer5", feat), head("layer6", feat)
                if train:
                    return x1, x2, feat
            probs = eval_tail([x1, x2], in_hw)
            return (probs, x1, x2, feat) if with_aux else probs
        feat = norm(pyramid[-1])
        x1 = head("cls_pred", feat)
        if train:
            return x1, feat
        probs = eval_tail([x1], in_hw)
        return (probs, x1, x1, feat) if with_aux else probs


@torch.no_grad()
def init_weights(model: nn.Module, generator: Optional[torch.Generator] = None
                 ) -> None:
    """The JAX package's initializers: kaiming-normal (fan_out) for the
    backbone and PPM convs (reference ``_resnets.py:166``), lecun-normal
    classifier with zero bias, N(0, 0.01) ASPP convs (``Encoder.py:77-78``),
    identity BatchNorm statistics."""
    for name, m in model.named_modules():
        if isinstance(m, nn.Conv2d):
            kh, kw = m.kernel_size
            if "conv2d_list" in name:
                std = 0.01
            elif m.bias is not None:  # PPM classifier (conv_last.4)
                std = 1.0 / math.sqrt(m.in_channels * kh * kw)
            else:
                std = math.sqrt(2.0 / (m.out_channels * kh * kw))
            m.weight.normal_(0.0, std, generator=generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.BatchNorm2d):
            m.weight.fill_(1.0)
            m.bias.zero_()
            m.running_mean.zero_()
            m.running_var.fill_(1.0)
