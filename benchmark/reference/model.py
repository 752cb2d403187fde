"""The plain reference of the benchmarked segmenter, in float32.

The published model of UemDA (reference ``uemda/models/Encoder.py:87-186``
and ``uemda/resnet.py``; ``DeeplabV2Config.uemda_default``): a torchvision
ResNet trunk with the output-stride surgery of ``resnet.py:192-207``, an
affine-free instance norm on the last feature map, and twin PSP heads
(``Encoder.py:8-84``) whose eval output is the mean of the two heads'
softmax at input resolution, upsampled with ``align_corners=True``.

Written with plain ``torch.nn.functional`` calls over a flat dict of
tensors named as the reference's state dicts name them. It imports nothing
of the measured program and nothing of JAX. Departures from the published
model, each also the measured program's: the heads' dropout is elementwise
(the flax head's ``Dropout``), and its keep masks are given by the caller.

``quant`` rounds, as a program computing in that precision stores them,
every convolution's weight and every activation (each convolution's,
BatchNorm's, residual sum's, norm's and head's output) to ``"bf16"`` or to
``"fp8"`` (e4m3, each tensor scaled to the format's largest finite value),
with the gradient passed straight through; the arithmetic of each
operation stays f32. ``"fp8"`` is the benchmark's control: the nearest
precision below the bf16 the configuration states.
"""

import contextlib
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

BLOCKS = {"resnet18": ("basic", (2, 2, 2, 2)),
          "resnet50": ("bottleneck", (3, 4, 6, 3)),
          "resnet101": ("bottleneck", (3, 4, 23, 3))}
POOL_SCALES = (1, 2, 3, 6)
HEADS = ("layer5", "layer6")
PPM_WIDTH = 512
DROPOUT = 0.1
FP8_MAX = 448.0


def stage_plan(output_stride: int) -> Sequence[Tuple[int, int]]:
    """(stride, dilation) of layers 1-4 (``resnet.py:62-66``)."""
    return {32: [(1, 1), (2, 1), (2, 1), (2, 1)],
            16: [(1, 1), (2, 1), (2, 1), (1, 2)],
            8: [(1, 1), (2, 1), (1, 2), (1, 4)]}[output_stride]


def trunk_blocks(arch: str, output_stride: int = 16) -> List[dict]:
    """Every residual block: its name, widths, stride, the dilation of its
    3x3s and whether it has a projection."""
    kind, layers = BLOCKS[arch]
    exp = 4 if kind == "bottleneck" else 1
    out, cin = [], 64
    for si, (stride, dil) in enumerate(stage_plan(output_stride)):
        planes = (64, 128, 256, 512)[si]
        for bi in range(layers[si]):
            first = bi == 0
            out.append(dict(
                name=f"encoder.resnet.layer{si + 1}.{bi}", kind=kind,
                cin=cin, planes=planes, cout=planes * exp,
                stride=stride if first else 1,
                dil1=max(dil // 2, 1) if first else dil, dil2=dil,
                down=first and (stride != 1 or cin != planes * exp)))
            cin = planes * exp
    return out


def feature_channels(arch: str) -> int:
    return 512 * (4 if BLOCKS[arch][0] == "bottleneck" else 1)


def param_spec(arch: str, num_classes: int, output_stride: int = 16
               ) -> List[Tuple[str, Tuple[int, ...], str]]:
    """(name, shape, kind) of every tensor of the model's state dict, kind
    one of conv, classifier, bias, bn_weight, bn_last (the scale of the
    BatchNorm that ends a residual branch), bn_bias, bn_mean, bn_var,
    bn_count."""
    spec = []

    def conv(name, cout, cin, k):
        spec.append((name + ".weight", (cout, cin, k, k), "conv"))

    def bn(name, c, last=False):
        spec.extend([(name + ".weight", (c,), "bn_last" if last
                      else "bn_weight"),
                     (name + ".bias", (c,), "bn_bias"),
                     (name + ".running_mean", (c,), "bn_mean"),
                     (name + ".running_var", (c,), "bn_var"),
                     (name + ".num_batches_tracked", (), "bn_count")])

    conv("encoder.resnet.conv1", 64, 3, 7)
    bn("encoder.resnet.bn1", 64)
    for b in trunk_blocks(arch, output_stride):
        n = b["name"]
        if b["kind"] == "bottleneck":
            conv(n + ".conv1", b["planes"], b["cin"], 1)
            bn(n + ".bn1", b["planes"])
            conv(n + ".conv2", b["planes"], b["planes"], 3)
            bn(n + ".bn2", b["planes"])
            conv(n + ".conv3", b["cout"], b["planes"], 1)
            bn(n + ".bn3", b["cout"], last=True)
        else:
            conv(n + ".conv1", b["planes"], b["cin"], 3)
            bn(n + ".bn1", b["planes"])
            conv(n + ".conv2", b["planes"], b["planes"], 3)
            bn(n + ".bn2", b["planes"], last=True)
        if b["down"]:
            conv(n + ".downsample.0", b["cout"], b["cin"], 1)
            bn(n + ".downsample.1", b["cout"])
    fc = feature_channels(arch)
    for h in HEADS:
        for i in range(len(POOL_SCALES)):
            conv(f"{h}.ppm.{i}.1", PPM_WIDTH, fc, 1)
            bn(f"{h}.ppm.{i}.2", PPM_WIDTH)
        conv(f"{h}.conv_last.0", PPM_WIDTH, fc + PPM_WIDTH * len(POOL_SCALES),
             3)
        bn(f"{h}.conv_last.1", PPM_WIDTH)
        spec.append((f"{h}.conv_last.4.weight", (num_classes, PPM_WIDTH, 1, 1),
                     "classifier"))
        spec.append((f"{h}.conv_last.4.bias", (num_classes,), "bias"))
    return spec


class Net:
    """The model over ``params`` (name -> f32 tensor). ``train``: batch
    statistics in every BatchNorm and the heads' dropout (masks given);
    else the running statistics and no dropout."""

    def __init__(self, params: Dict[str, torch.Tensor], arch: str,
                 output_stride: int = 16, quant: Optional[str] = None):
        if quant not in (None, "bf16", "fp8"):
            raise ValueError(f"unknown quant {quant!r}")
        self.p, self.arch, self.os = params, arch, output_stride
        self.quant = quant

    def _q(self, t: torch.Tensor) -> torch.Tensor:
        if self.quant is None:
            return t
        if self.quant == "bf16":
            low = t.detach().to(torch.bfloat16).float()
        else:
            scale = t.detach().abs().amax().clamp_min(1e-30) / FP8_MAX
            low = (t.detach() / scale).to(torch.float8_e4m3fn).float() * scale
        return t + (low - t).detach()

    def conv(self, x, name, stride=1, dilation=1, bias=None):
        w = self.p[name + ".weight"]
        pad = dilation * (w.shape[-1] - 1) // 2
        return self._q(F.conv2d(self._q(x), self._q(w), bias, stride, pad,
                                dilation))

    def bn(self, x, name, train):
        p = self.p
        if train:
            return self._q(F.batch_norm(x, None, None, p[name + ".weight"],
                                        p[name + ".bias"], True, 0.0, 1e-5))
        return self._q(F.batch_norm(x, p[name + ".running_mean"],
                                    p[name + ".running_var"],
                                    p[name + ".weight"], p[name + ".bias"],
                                    False, 0.0, 1e-5))

    def block(self, x, b, train):
        n = b["name"]
        idt = x
        if b["down"]:
            idt = self.bn(self.conv(x, n + ".downsample.0", b["stride"]),
                          n + ".downsample.1", train)
        if b["kind"] == "bottleneck":
            y = F.relu(self.bn(self.conv(x, n + ".conv1"), n + ".bn1", train))
            y = F.relu(self.bn(self.conv(y, n + ".conv2", b["stride"],
                                         b["dil1"]), n + ".bn2", train))
            y = self.bn(self.conv(y, n + ".conv3"), n + ".bn3", train)
        else:
            y = F.relu(self.bn(self.conv(x, n + ".conv1", b["stride"],
                                         b["dil1"]), n + ".bn1", train))
            y = self.bn(self.conv(y, n + ".conv2", 1, b["dil2"]), n + ".bn2",
                        train)
        return F.relu(self._q(y + idt))

    def feature(self, x, train):
        """The trunk and the instance norm: (B, 3, H, W) -> (B, K, h, w)."""
        y = F.relu(self.bn(self.conv(x, "encoder.resnet.conv1", 2),
                           "encoder.resnet.bn1", train))
        y = F.max_pool2d(y, 3, 2, 1)
        for b in trunk_blocks(self.arch, self.os):
            y = self.block(y, b, train)
        return self._q(F.instance_norm(y, eps=1e-5))

    def head(self, feat, h, train, mask=None):
        h_, w_ = feat.shape[2:]
        outs = [feat]
        for i, s in enumerate(POOL_SCALES):
            y = F.adaptive_avg_pool2d(feat, s)
            y = F.relu(self.bn(self.conv(y, f"{h}.ppm.{i}.1"), f"{h}.ppm.{i}.2",
                               train))
            outs.append(self._q(F.interpolate(y, (h_, w_), mode="bilinear",
                                              align_corners=False)))
        y = torch.cat(outs, 1)
        y = F.relu(self.bn(self.conv(y, f"{h}.conv_last.0"),
                           f"{h}.conv_last.1", train))
        if train:
            keep = 1.0 - DROPOUT
            y = self._q(torch.where(mask, y / keep,
                                    torch.zeros((), device=y.device)))
        return self.conv(y, f"{h}.conv_last.4",
                         bias=self.p[f"{h}.conv_last.4.bias"])

    def train_forward(self, x, masks: Dict[str, torch.Tensor]):
        """(x1, x2, feat): both heads' logits and the feature, stride 16."""
        feat = self.feature(x, True)
        return (self.head(feat, HEADS[0], True, masks[HEADS[0]]),
                self.head(feat, HEADS[1], True, masks[HEADS[1]]), feat)

    def eval_probs(self, x):
        """(B, C, H, W): the mean of both heads' softmax at x's size."""
        feat = self.feature(x, False)
        hw = tuple(x.shape[2:])
        probs = [torch.softmax(F.interpolate(self.head(feat, h, False), hw,
                                             mode="bilinear",
                                             align_corners=True), 1)
                 for h in HEADS]
        return (probs[0] + probs[1]) * 0.5


@contextlib.contextmanager
def full_f32():
    """TF32 off for convolutions and matmuls, the previous settings put
    back afterwards."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old
