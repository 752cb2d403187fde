"""Operations of the segmenter's convolutions, from the configuration's
shapes.

One multiply-add counts two operations. The forward counts every
convolution of the standard model (the trunk, each head's pyramid branches,
its 3x3 fuse and its classifier); a training step's backward counts each
convolution twice more (the gradient of its weight and of its input), less
the stem's input gradient, which nothing needs. Pooling, norms, resizes,
elementwise work and recomputation are not counted. The fast path's folded
weights and space-to-depth stem compute the same function, so a served
window counts the same.
"""

from typing import List, Tuple

from benchmark.reference.model import (
    POOL_SCALES,
    PPM_WIDTH,
    feature_channels,
    trunk_blocks,
)


def _out(n: int, k: int, s: int, d: int) -> int:
    p = d * (k - 1) // 2
    return (n + 2 * p - d * (k - 1) - 1) // s + 1


def conv_macs(arch: str, num_classes: int, hw: Tuple[int, int],
              output_stride: int = 16) -> List[Tuple[str, int]]:
    """(name, multiply-adds) of every convolution of one image of ``hw``."""
    h, w = hw
    out = []

    def conv(name, cin, cout, k, s=1, d=1):
        nonlocal h, w
        h, w = _out(h, k, s, d), _out(w, k, s, d)
        out.append((name, cin * cout * k * k * h * w))

    conv("stem", 3, 64, 7, 2)
    h, w = _out(h, 3, 2, 1), _out(w, 3, 2, 1)            # max pool
    for b in trunk_blocks(arch, output_stride):
        h0, w0 = h, w
        if b["kind"] == "bottleneck":
            conv(b["name"] + ".conv1", b["cin"], b["planes"], 1)
            conv(b["name"] + ".conv2", b["planes"], b["planes"], 3,
                 b["stride"], b["dil1"])
            conv(b["name"] + ".conv3", b["planes"], b["cout"], 1)
        else:
            conv(b["name"] + ".conv1", b["cin"], b["planes"], 3, b["stride"],
                 b["dil1"])
            conv(b["name"] + ".conv2", b["planes"], b["planes"], 3, 1,
                 b["dil2"])
        if b["down"]:
            out.append((b["name"] + ".downsample", b["cin"] * b["cout"]
                        * _out(h0, 1, b["stride"], 1)
                        * _out(w0, 1, b["stride"], 1)))
    fc = feature_channels(arch)
    for head in ("layer5", "layer6"):
        for s in POOL_SCALES:
            out.append((f"{head}.ppm.{s}", fc * PPM_WIDTH * s * s))
        out.append((f"{head}.conv_last.0",
                    (fc + PPM_WIDTH * len(POOL_SCALES)) * PPM_WIDTH * 9 * h * w))
        out.append((f"{head}.conv_last.4", PPM_WIDTH * num_classes * h * w))
    return out


def forward_flops(arch: str, num_classes: int, hw, output_stride=16) -> int:
    """Operations of one image's forward."""
    return 2 * sum(m for _, m in conv_macs(arch, num_classes, hw,
                                           output_stride))


def train_flops(arch: str, num_classes: int, hw, output_stride=16) -> int:
    """Operations of one image's forward and backward."""
    macs = conv_macs(arch, num_classes, hw, output_stride)
    total = sum(m for _, m in macs)
    stem = macs[0][1]
    return 2 * (3 * total - stem)
