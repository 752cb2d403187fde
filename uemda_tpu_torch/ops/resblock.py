"""Fused identity bottleneck block: the K4 CUDA kernel and its plain version.

Port of ``uemda_tpu/ops/pallas_resblock.py:bottleneck_identity_pallas``:
``relu(conv3(relu(conv2(relu(conv1(x))))) + x)`` for a ResNet bottleneck
whose block keeps its width (stride 1, no downsample branch, Cin == Cout),
the 3x3 at ``dilation`` with SAME padding, BN folded into the weights. Each
conv's f32 sum is rounded to the activation dtype before the bias, cast to
that dtype, is added; the residual add runs in the dtype -- the rounding of
the fast path's ``_conv`` in the JAX package. The kernel is
``uemda_tpu_torch/kernels/csrc/resblock.cu``; it keeps the block's
intermediates in shared memory and writes only the output. The weights are
the serving params' folded OIHW tensors (channels_last memory), taken as
they are.

Each launch runs a plan (``bottleneck_plan``, pure Python, tested on the
CPU): the output tile, the wgmma design's configuration and weight-ring
depth (bf16), or the CUDA-core tile (f32), and the shared-memory layout the
kernel uses -- this module is its one owner. The C launcher checks the
plan's bounds and refuses one it cannot run.
"""

import ctypes
from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from uemda_tpu_torch import kernels

CL = torch.channels_last

SMEM_LIMIT = 232_448      # dynamic shared memory a block may opt into (H100)
MAX_STAGES = 4            # deepest weight ring a bf16 launch takes

# bf16 wgmma configurations, compiled into resblock.cu in this order:
# (KC, MT1, NW1, MT2, NW2, NW3). KC is the k-chunk of one ring stage (64:
# 128-byte rows, 128-byte swizzle; 16: 32-byte rows, 32-byte swizzle, for
# layer4's width, where y1 leaves ~80 KB and a 64-wide chunk of its 512
# weight rows is 64 KB: four 16 KB stages keep two loading). MT1 / MT2 are
# the 64-row m-tiles of conv1 (the haloed tile) and of conv2/conv3 (the
# output tile); NW1-NW3 the columns each of the two consumer warpgroups
# takes per pass of conv1, conv2 and conv3.
WGMMA_CONFIGS = (
    (64, 3, 32, 2, 32, 128),    # Cm <= 64 (layer1)
    (64, 3, 64, 2, 64, 128),    # Cm <= 128 (layer2)
    (64, 2, 128, 1, 128, 128),  # Cm <= 256 (layer3)
    (16, 3, 64, 1, 256, 256),   # Cm <= 512 (layer4)
)
# output tiles (TH, TW) the planner tries; the largest that fits is taken
WGMMA_TILES = ((8, 16), (8, 8), (4, 16), (4, 8), (4, 4), (2, 8), (2, 4),
               (2, 2), (1, 4), (1, 2), (1, 1))
FMA_TILES = ((16, 16), (8, 16), (8, 8), (4, 8), (4, 4), (2, 4), (2, 2),
             (1, 2), (1, 1))


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _round_up(a: int, b: int) -> int:
    return _cdiv(a, b) * b


@dataclass(frozen=True)
class BottleneckPlan:
    """One launch of K4. ``design`` is "wgmma" (bf16: tensor cores, TMA
    weight ring) or "fma" (f32: CUDA cores). ``config`` indexes
    ``WGMMA_CONFIGS`` (-1 for fma); ``stages`` is the ring depth (0 for
    fma); ``grid`` (x, y, z) is (column tiles, row tiles, batch).

    Shared memory, in bytes from the (1024-aligned, wgmma) base: y1 at 0,
    y2 at ``y2_off`` (0 where y2 takes y1's place); the wgmma ring at
    ``region``, ``stages`` stages of ``stage`` bytes, then two 8-byte
    mbarriers a stage; ``smem`` is the whole (fma: region and stage 0)."""
    design: str
    config: int
    tile: Tuple[int, int]
    stages: int
    smem: int
    y2_off: int
    region: int
    stage: int
    grid: Tuple[int, int, int]

    def as_ints(self):
        """The int array the C launcher takes: design (1 wgmma, 0 fma),
        config, TH, TW, stages, smem, y2_off, region, stage (bytes), grid
        x, y, z."""
        return [int(self.design == "wgmma"), self.config, *self.tile,
                self.stages, self.smem, self.y2_off, self.region, self.stage,
                *self.grid]


def wgmma_layout(config: int, cmid: int, dil: int, th: int, tw: int,
                 stages: int) -> Tuple[int, int, int, int]:
    """(y2_off, region, stage, smem) of a wgmma launch. y1 (the haloed tile
    after conv1) is ceil(Cm / KC) chunks of round_up(P1, 8) rows of KC bf16;
    y2 (the output tile after conv2) the same chunks of MT2 * 64 rows. With
    one conv2 pass (Cm <= 2 NW2) every read of y1 is over before y2 is
    written, so y2 takes y1's place. A ring stage holds conv1's x chunk
    (MT1 * 64 rows) beside its w1 chunk, or one chunk of w2 or w3. Every
    TMA destination lies on 1024 bytes (the 128-byte swizzle's period);
    1024 more bytes align the dynamic base."""
    kc, mt1, nw1, mt2, nw2, nw3 = WGMMA_CONFIGS[config]
    rb = 2 * kc
    p1 = (th + 2 * dil) * (tw + 2 * dil)
    ncm = _cdiv(cmid, kc)
    y1 = _round_up(ncm * _round_up(p1, 8) * rb, 1024)
    y2 = _round_up(ncm * mt2 * 64 * rb, 1024)
    if cmid <= 2 * nw2:
        y2_off, region = 0, max(y1, y2)
    else:
        y2_off, region = y1, y1 + y2
    stage = _round_up(max(mt1 * 64 * rb + 2 * nw1 * rb, 2 * nw2 * rb,
                          2 * nw3 * rb), 1024)
    return y2_off, region, stage, 1024 + region + stages * (stage + 16)


def fma_layout(cmid: int, dil: int, th: int, tw: int) -> Tuple[int, int]:
    """(y2_off, smem) of the f32 kernel: y1 over the haloed tile and y2
    over the output tile, f32 rows padded by 4 elements, 16 rows at a
    time."""
    p1 = (th + 2 * dil) * (tw + 2 * dil)
    row = (cmid + 4) * 4
    y2_off = _round_up(p1, 16) * row
    return y2_off, y2_off + _round_up(th * tw, 16) * row


def bottleneck_plan(b: int, h: int, w: int, cin: int, cmid: int, dil: int,
                    dtype: torch.dtype, n_sm: int = kernels.N_SM
                    ) -> Optional[BottleneckPlan]:
    """The launch plan of K4 for x (b, cin, h, w) and Cm ``cmid`` at
    ``dil``, or None where no plan fits ``SMEM_LIMIT`` bytes.

    bf16 (wgmma): the configuration is the narrowest whose conv2 covers Cm
    in one pass (the widest for Cm > 512); the tile is the largest whose
    haloed tile fits MT1 m-tiles and whose output fits MT2 (any
    configuration that covers Cm may give it, e.g. a dilation of 4); the
    ring is as deep as shared memory allows, up to ``MAX_STAGES``.
    f32 (fma, CUDA cores): the largest tile that fits and still gives at
    least half as many blocks as the card has SMs, below 4 x 4 only when
    nothing larger fits."""
    if dtype == torch.bfloat16:
        cover = [i for i, c in enumerate(WGMMA_CONFIGS) if 2 * c[4] >= cmid]
        cover = cover or [len(WGMMA_CONFIGS) - 1]
        best = None
        for cfg in cover:
            _, mt1, _, mt2, _, _ = WGMMA_CONFIGS[cfg]
            for th, tw in WGMMA_TILES:
                p1 = (th + 2 * dil) * (tw + 2 * dil)
                if p1 > 64 * mt1 or th * tw > 64 * mt2:
                    continue
                stages = 0
                for s_ in range(MAX_STAGES, 1, -1):
                    if wgmma_layout(cfg, cmid, dil, th, tw, s_)[3] \
                            <= SMEM_LIMIT:
                        stages = s_
                        break
                if not stages:
                    continue
                key = (th * tw, -p1, -cfg)
                if best is None or key > best[0]:
                    best = (key, cfg, (th, tw), stages)
                break
        if best is None:
            return None
        _, cfg, (th, tw), stages = best
        y2_off, region, stage, smem = wgmma_layout(cfg, cmid, dil, th, tw,
                                                   stages)
        return BottleneckPlan("wgmma", cfg, (th, tw), stages, smem, y2_off,
                              region, stage, (_cdiv(w, tw), _cdiv(h, th), b))
    if dtype != torch.float32:
        raise TypeError(f"bottleneck_plan: dtype {dtype}")
    pick = None
    for th, tw in FMA_TILES:
        y2_off, smem = fma_layout(cmid, dil, th, tw)
        if smem > SMEM_LIMIT:
            continue
        if pick and th * tw < 16:
            break
        pick = (th, tw, y2_off, smem)
        if b * _cdiv(h, th) * _cdiv(w, tw) >= n_sm // 2:
            break
    if pick is None:
        return None
    th, tw, y2_off, smem = pick
    return BottleneckPlan("fma", -1, (th, tw), 0, smem, y2_off, 0, 0,
                          (_cdiv(w, tw), _cdiv(h, th), b))


def bottleneck_identity_plain(x: torch.Tensor, w1: torch.Tensor,
                              b1: torch.Tensor, w2: torch.Tensor,
                              b2: torch.Tensor, w3: torch.Tensor,
                              b3: torch.Tensor, dilation: int = 1
                              ) -> torch.Tensor:
    """``tests/test_pallas_resblock.py:13-27``: each conv without its bias,
    the output rounded to x's dtype, the bias cast to the dtype and added,
    then ReLU; the residual add in the dtype."""
    dt = x.dtype

    def conv(h, w, b, pad, d=1):
        y = F.conv2d(h, w.to(dt), None, 1, pad, d)
        return y + b.to(dt).view(1, -1, 1, 1)

    y = torch.relu(conv(x, w1, b1, 0))
    y = torch.relu(conv(y, w2, b2, dilation, dilation))
    y = conv(y, w3, b3, 0)
    return torch.relu(y + x).contiguous(memory_format=CL)


def _check_fusable(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor,
                  w3: torch.Tensor, dilation: int) -> None:
    """Raise ValueError on a block the fused kernel does not compute: what
    ``infer.fastpath._fusable`` refuses (an int8 entry, a middle conv that is
    not 3x3, Cin != Cout), or mismatched shapes."""
    for name, w in (("w1", w1), ("w2", w2), ("w3", w3)):
        if not w.is_floating_point():
            raise ValueError(f"bottleneck_identity {name}: {w.dtype} weights "
                             "(an int8 entry) do not fuse")
    if x.dim() != 4:
        raise ValueError(f"bottleneck_identity x: expected (B, C, H, W), got "
                         f"{tuple(x.shape)}")
    cin, cmid = x.shape[1], w1.shape[0]
    if tuple(w2.shape[2:]) != (3, 3):
        raise ValueError(f"bottleneck_identity: the middle conv must be 3x3, "
                         f"got {tuple(w2.shape)}")
    if (tuple(w1.shape) != (cmid, cin, 1, 1)
            or tuple(w2.shape) != (cmid, cmid, 3, 3)
            or tuple(w3.shape) != (cin, cmid, 1, 1)):
        raise ValueError(
            f"bottleneck_identity takes an identity block (Cin == Cout): x "
            f"{tuple(x.shape)}, w1 {tuple(w1.shape)}, w2 {tuple(w2.shape)}, "
            f"w3 {tuple(w3.shape)}")
    if int(dilation) < 1:
        raise ValueError(f"bottleneck_identity: dilation {dilation} < 1")


def bottleneck_identity(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                        w2: torch.Tensor, b2: torch.Tensor, w3: torch.Tensor,
                        b3: torch.Tensor, dilation: int = 1) -> torch.Tensor:
    """x (B, C, H, W) channels_last, bf16 or f32; w1 (Cm, C, 1, 1), w2 (Cm,
    Cm, 3, 3) and w3 (C, Cm, 1, 1) in x's dtype, channels_last; biases f32.
    Returns the block's output, a new channels_last tensor. A CPU tensor
    takes the plain version; a CUDA tensor launches the kernel (C and Cm
    multiples of 16)."""
    _check_fusable(x, w1, w2, w3, dilation)
    if x.device.type == "cpu":
        return bottleneck_identity_plain(x, w1, b1, w2, b2, w3, b3, dilation)
    kernels.check_cuda_input(x, "bottleneck_identity x")
    for name, w in (("w1", w1), ("w2", w2), ("w3", w3)):
        kernels.check_cuda_input(w, f"bottleneck_identity {name}",
                                 dtypes=(x.dtype,))
    for name, b in (("b1", b1), ("b2", b2), ("b3", b3)):
        kernels.check_cuda_input(b, f"bottleneck_identity {name}", ndim=1,
                                 dtypes=(torch.float32,), channels_last=False)
    bsz, cin, h, w = x.shape
    cmid = w1.shape[0]
    if cin % 16 or cmid % 16:
        raise ValueError(f"bottleneck_identity: the kernel takes C and Cm in "
                         f"multiples of 16, got {cin}, {cmid}")
    if tuple(b1.shape) != (cmid,) or tuple(b2.shape) != (cmid,) \
            or tuple(b3.shape) != (cin,):
        raise ValueError(f"bottleneck_identity biases {tuple(b1.shape)}, "
                         f"{tuple(b2.shape)}, {tuple(b3.shape)} for C {cin}, "
                         f"Cm {cmid}")
    plan = bottleneck_plan(bsz, h, w, cin, cmid, int(dilation), x.dtype,
                           n_sm=kernels.sm_count(x.device))
    if plan is None:
        raise ValueError(f"bottleneck_identity: no tile of Cm {cmid} at "
                         f"dilation {dilation} fits shared memory")
    out = torch.empty_like(x, memory_format=CL)
    ptrs = [t.data_ptr() for t in (x, w1, b1, w2, b2, w3, b3, out)]
    ints = plan.as_ints()
    arr = (ctypes.c_int * len(ints))(*ints)
    fn = kernels.function("resblock", "uemda_bottleneck_identity",
                          [kernels.P] * 8 + [kernels.I] * 6
                          + [kernels.P, kernels.I, kernels.P])
    with torch.cuda.device(x.device):
        err = fn(*ptrs, bsz, h, w, cin, cmid, int(dilation),
                 ctypes.addressof(arr), len(ints), kernels.stream_of(x))
    kernels.check_launch("resblock", "uemda_bottleneck_identity", err)
    bottleneck_identity.launches += 1
    bottleneck_identity.plan = plan
    return out


bottleneck_identity.launches = 0
bottleneck_identity.plan = None  # the BottleneckPlan of the last launch
