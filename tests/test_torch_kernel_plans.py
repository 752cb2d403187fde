"""Launch plans of the port's redesigned kernels, on the CPU: K4's
(``ops/resblock.py: bottleneck_plan``), K2's (``ops/stem.py:
stem_plan``), the K1 backward's (``ops/insnorm.py:
instance_norm_backward_plan``) and K7's (``ops/segment.py:
segment_gather_plan``). Every identity bottleneck of ResNet-50 and ResNet-101 at
output stride 8 and 16 on 512^2 tiles, and every shape the GPU tests run,
gets a plan that fits the H100's 232,448 bytes of shared memory a block; the
wgmma path's haloed and output tiles fit its 64-row m-tiles; the plan's
shared-memory layout holds every operand the kernel reads where it reads it,
with every TMA destination on its swizzle's period; the grid covers every
output pixel once. Every instance-norm shape of the training paths gets a
K1 backward plan within shared memory, a portable cluster, a grid of
whole clusters and the stated route, and covers every (sample, channel,
pixel) once; K7's plan writes every output float of every sample once,
with its 16-byte stores aligned. K3's plan (``ops/tail.py: tail_plan``)
writes every output element once with aligned 16-byte stores from input
windows within its bound, and an emulation of its arithmetic matches the
JAX tail; K8's plan (``ops/mine.py: uvem_mine_plan``) picks the route of
each layout and visits every pixel once in both passes, and an emulation
of its two passes is bit-equal to its plain version. The CUDA launchers
check the plans' bounds again on the card."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from uemda_tpu_torch import kernels
from uemda_tpu_torch.models.resnet import RESNET_SPECS, stage_plan
from uemda_tpu_torch.ops import resblock, segment, stem
from uemda_tpu_torch.ops.insnorm import (
    bwd_static_smem,
    fwd_static_smem,
    instance_norm_backward_plan,
    instance_norm_forward_plan,
)
from uemda_tpu_torch.ops.resblock import (
    SMEM_LIMIT,
    WGMMA_CONFIGS,
    bottleneck_plan,
    wgmma_layout,
)
from uemda_tpu_torch.ops.segment import (
    reduce_smem,
    segment_gather_plan,
    segment_reduce_plan,
)
from uemda_tpu_torch.ops import mine
from uemda_tpu_torch.ops.mine import uvem_mine_plain, uvem_mine_plan
from uemda_tpu_torch.ops.stem import stem_plan
from uemda_tpu_torch.ops.tail import (
    TAIL_STATIC_NC,
    TAIL_THREADS,
    tail_chunk_elems,
    tail_plan,
    tail_scales,
    tail_smem,
)
from uemda_tpu_torch.ops.uncertainty import pixel_entropy

CSRC = Path(resblock.__file__).resolve().parents[1] / "kernels" / "csrc"
TILE = 512
BF16, F32 = torch.bfloat16, torch.float32


def identity_blocks(net: str, output_stride: int):
    """(C, H, W, Cm, dilation) of every identity bottleneck (blocks 1+ of a
    stage) of ``net`` on a TILE^2 input: the stem and its pool leave
    TILE / 4; stage i has Cm = 64 * 2^i and C = 4 Cm."""
    _, layers, _, _, _ = RESNET_SPECS[net]
    side = TILE // 4
    out = []
    for i, ((stride, dilate), n) in enumerate(zip(stage_plan(output_stride),
                                                  layers)):
        side //= stride
        cm = 64 * 2 ** i
        out += [(4 * cm, side, side, cm, dilate)] * (n - 1)
    return sorted(set(out))


# tests/test_torch_gpu.py: test_bottleneck_identity_kernel's shapes
GPU_K4 = [((2, 64, 37, 53), 16, 1), ((2, 64, 37, 53), 16, 2),
          ((2, 256, 20, 24), 64, 1), ((8, 256, 96, 96), 64, 1),
          ((1, 512, 6, 6), 128, 2), ((1, 2048, 6, 6), 512, 2),
          ((1, 1024, 9, 7), 256, 4), ((3, 256, 24, 40), 64, 1),
          ((1, 2048, 32, 32), 512, 2), ((1, 2048, 5, 7), 512, 2),
          ((1, 64, 5, 7), 1024, 1)]


def _ru(a, b):
    return -(-a // b) * b


def _check_wgmma_plan(p, h, w, cmid, dil):
    kc, mt1, nw1, mt2, nw2, nw3 = WGMMA_CONFIGS[p.config]
    th, tw = p.tile
    p1 = (th + 2 * dil) * (tw + 2 * dil)
    assert p.design == "wgmma"
    assert 2 <= p.stages <= resblock.MAX_STAGES
    # wgmma takes 64-row m-tiles: the haloed tile fits conv1's MT1 of them,
    # the output tile conv2's and conv3's MT2
    assert p1 <= 64 * mt1 and th * tw <= 64 * mt2
    # a TMA box side is at most 256
    assert th + 2 * dil <= 256 and tw + 2 * dil <= 256
    assert p.grid == (-(-w // tw), -(-h // th), p.grid[2])
    assert len(p.as_ints()) == 12
    # the layout holds what resblock.cu reads: y1, ceil(Cm / KC) chunks of
    # round_up(P1, 8) rows of KC bf16, from 0; y2, the same chunks of MT2
    # 64-row m-tiles, from y2_off; the ring past both
    rb, ncm = 2 * kc, -(-cmid // kc)
    y1, y2 = ncm * _ru(p1, 8) * rb, ncm * mt2 * 64 * rb
    assert y1 <= p.region and p.y2_off + y2 <= p.region
    # y2 takes y1's place only where conv2 reads all of y1 in one pass
    if p.y2_off == 0:
        assert cmid <= 2 * nw2
    else:
        assert p.y2_off >= y1
    # a stage holds conv1's x chunk (MT1 m-tiles) and its w1 chunk, or the
    # two warpgroups' w2 or w3 chunk
    assert p.stage >= max(mt1 * 64 * rb + 2 * nw1 * rb, 2 * nw2 * rb,
                          2 * nw3 * rb)
    # every TMA destination (y1 / y2 / ring bases, each stage, the w chunk
    # beside x's, each warpgroup's half) lies on the swizzle's period: 8
    # rows of 128 B (KC 64) or of 32 B (KC 16), from a 1024-aligned base
    period = 8 * rb
    for off in (p.y2_off, p.region, p.stage, mt1 * 64 * rb, nw1 * rb,
                nw2 * rb, nw3 * rb):
        assert off % period == 0
    assert p.region % 1024 == 0 and p.stage % 1024 == 0
    # the 1024-byte alignment slack, the ring and two mbarriers a stage
    assert p.smem == 1024 + p.region + p.stages * (p.stage + 16)
    assert p.smem <= SMEM_LIMIT


def _check_fma_plan(q, cmid, dil):
    th, tw = q.tile
    row = (cmid + 4) * 4
    assert q.design == "fma" and q.stages == 0 and q.config == -1
    assert q.region == 0 and q.stage == 0 and q.y2_off % 16 == 0
    assert q.y2_off >= (th + 2 * dil) * (tw + 2 * dil) * row
    assert q.smem - q.y2_off >= th * tw * row and q.smem <= SMEM_LIMIT


@pytest.mark.parametrize("output_stride", [8, 16])
@pytest.mark.parametrize("net", ["resnet50", "resnet101"])
def test_k4_plans_fit_every_resnet_identity_block(net, output_stride):
    blocks = identity_blocks(net, output_stride)
    assert len(blocks) == 4  # one shape a stage
    for c, h, w, cmid, dil in blocks:
        for b in (1, 8, 32):
            p = bottleneck_plan(b, h, w, c, cmid, dil, BF16)
            _check_wgmma_plan(p, h, w, cmid, dil)
            # the ring is as deep as shared memory allows (OS 8's layer4,
            # a 4 x 8 tile at dilation 4 with 192 KB of y1, keeps 2)
            assert p.stages == resblock.MAX_STAGES or wgmma_layout(
                p.config, cmid, dil, *p.tile, p.stages + 1)[3] > SMEM_LIMIT
            if (output_stride, cmid) != (8, 512):
                assert p.stages >= 3
            _check_fma_plan(bottleneck_plan(b, h, w, c, cmid, dil, F32), cmid,
                            dil)


def test_k4_plans_of_the_flagship_stages():
    """The four stage shapes of chip_smoke.py (ResNet-50 OS16, batch 8):
    the configuration and tile each takes."""
    got = {cm: bottleneck_plan(8, h, w, c, cm, d, BF16)
           for c, h, w, cm, d in identity_blocks("resnet50", 16)}
    assert {cm: (p.config, p.tile) for cm, p in got.items()} == {
        64: (0, (8, 16)), 128: (1, (8, 16)), 256: (2, (8, 8)),
        512: (3, (8, 8))}
    assert WGMMA_CONFIGS[got[512].config][0] == 16   # layer4: KC 16
    assert got[512].grid == (4, 4, 8)


@pytest.mark.parametrize("shape,cmid,dil", GPU_K4)
@pytest.mark.parametrize("dtype", [F32, BF16])
def test_k4_plans_fit_the_gpu_test_shapes(shape, cmid, dil, dtype):
    b, c, h, w = shape
    p = bottleneck_plan(b, h, w, c, cmid, dil, dtype)
    assert p is not None
    if dtype == BF16:
        _check_wgmma_plan(p, h, w, cmid, dil)
    else:
        _check_fma_plan(p, cmid, dil)


def _coverage(h, w, th, tw, gx, gy):
    """How many blocks of a (gx, gy) grid of th x tw tiles write each
    pixel of an h x w map."""
    n = np.zeros((h, w), np.int64)
    for by in range(gy):
        for bx in range(gx):
            n[by * th:min((by + 1) * th, h), bx * tw:min((bx + 1) * tw, w)] += 1
    return n


@pytest.mark.parametrize("hw", [(37, 53), (9, 7), (6, 6), (32, 32),
                                (128, 128), (5, 7)])
@pytest.mark.parametrize("dtype", [F32, BF16])
def test_k4_grid_covers_every_pixel_once(hw, dtype):
    h, w = hw
    for c, cmid, dil in ((64, 16, 1), (1024, 256, 4), (2048, 512, 2)):
        p = bottleneck_plan(2, h, w, c, cmid, dil, dtype)
        assert p.grid[2] == 2
        cov = _coverage(h, w, *p.tile, p.grid[0], p.grid[1])
        assert (cov == 1).all()
        # no block lies wholly outside the map
        assert (p.grid[0] - 1) * p.tile[1] < w and (p.grid[1] - 1) * p.tile[0] < h


def test_k4_configs_match_the_cuda_source():
    """resblock.cu compiles one kernel per entry of WGMMA_CONFIGS, in the
    same order: the plan's config index picks it."""
    src = (CSRC / "resblock.cu").read_text()
    body = re.search(r"kConfigs\[\]\[6\] = \{(.*?)\};", src, re.S).group(1)
    rows = [tuple(int(v) for v in r.split(","))
            for r in re.findall(r"\{([^{}]*)\}", body)]
    assert rows == [tuple(c) for c in WGMMA_CONFIGS]


def test_k4_smem_of_layer4_by_hand():
    """Layer4 (Cm 512, 8 x 8 tile, dilation 2, KC 16): y1 is 144 px x 512
    channels of bf16 (y2, 64 x 512, takes its place), four 16 KB stages, 1
    KB of alignment, two 8-byte mbarriers a stage."""
    p = bottleneck_plan(8, 32, 32, 2048, 512, 2, BF16)
    assert (p.y2_off, p.region, p.stage) == (0, 144 * 512 * 2, 512 * 16 * 2)
    assert p.smem == 1024 + 144 * 512 * 2 + 4 * 512 * 16 * 2 + 4 * 16


def test_k4_wider_than_one_conv2_pass_keeps_y2_apart():
    """Cm above 512 needs conv2 in passes, so y2 cannot take y1's place."""
    p = bottleneck_plan(1, 5, 7, 64, 1024, 1, BF16)
    assert p is not None and p.y2_off > 0
    _check_wgmma_plan(p, 5, 7, 1024, 1)


@pytest.mark.parametrize("h2w2", [(256, 256), (32, 32), (36, 20), (15, 21),
                                  (66, 34), (30, 30), (2, 2)])
@pytest.mark.parametrize("b", [1, 2, 8])
def test_stem_plans_cover_every_pooled_pixel_once(b, h2w2):
    h2, w2 = h2w2
    h4, w4 = (h2 + 1) // 2, (w2 + 1) // 2
    p = stem_plan(b, h2, w2, BF16)
    assert p.design == "mma" and p.smem <= SMEM_LIMIT
    assert p.tile == (16, 16) and len(p.as_ints()) == 7
    n_tiles = b * -(-h4 // 16) * -(-w4 // 16)
    # a persistent grid: at most one block a SM, each walking its tiles
    assert p.grid[1:] == (1, 1) and 1 <= p.grid[0] <= min(n_tiles, kernels.N_SM)
    walked = [t for blk in range(p.grid[0])
              for t in range(blk, n_tiles, p.grid[0])]
    assert sorted(walked) == list(range(n_tiles))
    tx, ty = -(-w4 // 16), -(-h4 // 16)
    assert n_tiles == b * tx * ty
    assert (_coverage(h4, w4, 16, 16, tx, ty) == 1).all()
    q = stem_plan(b, h2, w2, F32)
    assert q.design == "fma" and q.smem <= SMEM_LIMIT
    assert q.grid == (-(-w4 // 8), -(-h4 // 8), b)
    assert (_coverage(h4, w4, 8, 8, q.grid[0], q.grid[1]) == 1).all()


def test_stem_smem_by_hand():
    """bf16: the 36 x 36 x 12 input tile, the 64 x (192 + 8) weight and the
    33 x 33 x (64 + 8) conv tile, all bf16; the same sizes stem.cu checks."""
    assert stem.BF16_SMEM == 2 * (36 * 36 * 12 + 64 * 200 + 33 * 33 * 72)
    src = (CSRC / "stem.cu").read_text()
    assert "constexpr int BP = 16;" in src and "constexpr int WLD = KDIM + 8;" in src
    assert "constexpr int CLD = COUT + 8;" in src


# --- K1 backward ----------------------------------------------------------

def _check_bwd_plan(p, b, c, hw, dtype, inputs=2, static=bwd_static_smem):
    """The plan's bounds, and that its grid covers every (sample, channel,
    pixel) of a (b, c, hw) slab once, as insnorm.cu's kernels (the backward
    staging x and dy; the forward, ``inputs`` 1, x) map CTAs and threads:
    blockIdx.x -> (chunk blockIdx.x / cluster, rank blockIdx.x % cluster),
    pixels [rank ppc, min(hw, (rank + 1) ppc)); thread t -> 16-byte column
    t % VPR of pixels t / VPR, + G, ..."""
    esz = 2 if dtype == BF16 else 4
    assert p.cb in (32, 64) and c % p.cb == 0
    assert 1 <= p.cluster <= 8 and p.grid[0] % p.cluster == 0
    assert p.grid == (p.cluster * c // p.cb, b) and b <= 65535
    assert p.ppc == -(-hw // p.cluster) and len(p.as_ints()) == 7
    if p.route == "smem":
        assert p.smem == inputs * p.ppc * p.cb * esz
        assert p.smem + static(p.cb) <= SMEM_LIMIT
    else:
        assert p.route == "global" and p.smem == 0
        # global only where no width fits at this cluster
        assert inputs * p.ppc * 32 * esz + static(32) > SMEM_LIMIT
    # the grid's x index is a one-to-one map onto (chunk, rank)
    gx = np.arange(p.grid[0])
    chunk, rank = gx // p.cluster, gx % p.cluster
    assert len(set(zip(chunk, rank))) == p.grid[0]
    chan = np.zeros(c, np.int64)
    for k in range(c // p.cb):
        chan[k * p.cb:(k + 1) * p.cb] += 1
    pix = np.zeros(hw, np.int64)
    nps = []
    for r in range(p.cluster):
        p0, p1 = r * p.ppc, min(hw, (r + 1) * p.ppc)
        pix[p0:max(p0, p1)] += 1
        nps.append(max(0, p1 - p0))
    assert (chan == 1).all() and (pix == 1).all()
    # inside a CTA: 256 threads over its np pixels x cb channels
    epv = 16 // esz
    vpr = p.cb // epv
    groups = 256 // vpr
    assert vpr <= 32 and 32 % vpr == 0
    for n_px in set(nps):
        cta = np.zeros((n_px, p.cb), np.int64)
        for t in range(256):
            j, g = t % vpr, t // vpr
            cta[g:n_px:groups, j * epv:(j + 1) * epv] += 1
        assert (cta == 1).all()
    return nps


@pytest.mark.parametrize("dtype", [BF16, F32])
@pytest.mark.parametrize("output_stride", [8, 16, 32])
@pytest.mark.parametrize("c", [512, 2048])
def test_k1_backward_plans_of_the_training_shapes(c, output_stride, dtype):
    """The feature the instance norm takes: ResNet-18/34's 512 channels and
    ResNet-50/101's 2048, on 512^2 crops at output stride 8, 16 and 32,
    batch 8: every one on the shared-memory route, f32 at 32 x 32 among
    them."""
    side = TILE // output_stride
    p = instance_norm_backward_plan(8, c, side, side, dtype)
    _check_bwd_plan(p, 8, c, side * side, dtype)
    assert p.route == "smem"


# tests/test_torch_gpu.py: test_instance_norm_backward_kernel's shapes and
# the route each takes
GPU_K1_BWD = [((2, 256, 8, 8), "smem"), ((1, 96, 64, 64), "smem"),
              ((3, 2048, 32, 32), "smem"), ((2, 64, 9, 7), "smem"),
              ((3, 96, 20, 28), "smem"), ((2, 96, 45, 47), "smem"),
              ((1, 32, 128, 128), "global")]


@pytest.mark.parametrize("shape,route", GPU_K1_BWD)
@pytest.mark.parametrize("dtype", [BF16, F32])
def test_k1_backward_plans_of_the_gpu_test_shapes(shape, route, dtype):
    b, c, h, w = shape
    p = instance_norm_backward_plan(b, c, h, w, dtype)
    _check_bwd_plan(p, b, c, h * w, dtype)
    assert p.route == route


@pytest.mark.parametrize("cluster", [1, 2, 3, 4, 8])
def test_k1_backward_pinned_clusters_cover_a_ragged_slab(cluster):
    """9 x 7 = 63 pixels split 2, 4 or 8 ways leaves a short last CTA (8
    ways: 8 x 8, the last 7); a cluster of 3 splits it evenly."""
    for dtype in (BF16, F32):
        for cb in (32, 64):
            p = instance_norm_backward_plan(2, 64, 9, 7, dtype, cb=cb,
                                            cluster=cluster)
            nps = _check_bwd_plan(p, 2, 64, 63, dtype)
            assert sum(nps) == 63
            assert nps[-1] == 63 - (cluster - 1) * -(-63 // cluster)


def test_k1_backward_plan_of_the_flagship_by_hand():
    """(8, 2048, 32, 32): bf16 in 64-channel chunks, 4 CTAs of 256 pixels
    a slab, 64 KB of x and dy each; f32 the same 64 KB in 8 CTAs of 128
    pixels. f32 at 64 x 64 keeps shared memory at 32 channels (128 KB);
    the global route starts where 8 CTAs' parts overflow it at 32."""
    p = instance_norm_backward_plan(8, 2048, 32, 32, BF16)
    assert (p.route, p.cb, p.cluster, p.ppc, p.smem, p.grid) == (
        "smem", 64, 4, 256, 65536, (128, 8))
    q = instance_norm_backward_plan(8, 2048, 32, 32, F32)
    assert (q.route, q.cb, q.cluster, q.ppc, q.smem) == (
        "smem", 64, 8, 128, 65536)
    r = instance_norm_backward_plan(8, 2048, 64, 64, F32)
    assert (r.route, r.cb, r.cluster, r.smem) == ("smem", 32, 8, 131072)
    assert instance_norm_backward_plan(1, 64, 96, 96, F32).route == "global"
    assert instance_norm_backward_plan(1, 64, 96, 96, BF16).route == "smem"


def test_k1_backward_static_smem_matches_the_cuda_source():
    """insnorm.cu's backward declares red[2][WARPS][CB], part[2][CB] and
    stat[2][CB] f32 with WARPS = 256 / 32: the plan's bwd_static_smem."""
    src = (CSRC / "insnorm.cu").read_text()
    for decl in ("__shared__ float red[2][WARPS][CB];",
                 "__shared__ float part[2][CB];",
                 "__shared__ float stat[2][CB];",
                 "constexpr int kThreads = 256;"):
        assert decl in src
    assert bwd_static_smem(64) == (2 * 8 + 2 + 2) * 64 * 4


# --- K1 forward -----------------------------------------------------------

def _check_fwd_plan(p, b, c, hw, dtype):
    return _check_bwd_plan(p, b, c, hw, dtype, 1, fwd_static_smem)


@pytest.mark.parametrize("dtype", [BF16, F32])
@pytest.mark.parametrize("output_stride", [8, 16, 32])
@pytest.mark.parametrize("c,batch", [(512, 8), (2048, 8), (2048, 32)])
def test_k1_forward_plans_of_the_training_and_serving_shapes(c, batch,
                                                             output_stride,
                                                             dtype):
    """The feature the instance norm takes, on 512^2 crops at output
    stride 8, 16 and 32: ResNet-18/34's 512 channels and ResNet-50/101's
    2048 at the training batch of 8, and 2048 at the serving batch of 32;
    every one on the shared-memory route."""
    side = TILE // output_stride
    p = instance_norm_forward_plan(batch, c, side, side, dtype)
    _check_fwd_plan(p, batch, c, side * side, dtype)
    assert p.route == "smem"


# tests/test_torch_gpu.py: the K1 forward's shapes and the route each takes
GPU_K1_FWD = [((2, 256, 8, 8), "smem", "smem"), ((1, 96, 64, 64), "smem", "smem"),
              ((3, 2048, 32, 32), "smem", "smem"),
              ((8, 2048, 32, 32), "smem", "smem"),
              ((32, 2048, 32, 32), "smem", "smem"),
              ((3, 96, 20, 28), "smem", "smem"), ((2, 96, 45, 47), "smem", "smem"),
              ((2, 64, 64, 64), "smem", "smem"), ((2, 64, 9, 7), "smem", "smem"),
              ((1, 32, 128, 128), "smem", "global"),
              ((1, 32, 192, 192), "global", "global")]


@pytest.mark.parametrize("shape,bf16_route,f32_route", GPU_K1_FWD)
def test_k1_forward_plans_of_the_gpu_test_shapes(shape, bf16_route,
                                                 f32_route):
    b, c, h, w = shape
    for dtype, route in ((BF16, bf16_route), (F32, f32_route)):
        p = instance_norm_forward_plan(b, c, h, w, dtype)
        _check_fwd_plan(p, b, c, h * w, dtype)
        assert p.route == route


@pytest.mark.parametrize("cluster", [1, 2, 3, 4, 8])
def test_k1_forward_pinned_clusters_cover_a_ragged_slab(cluster):
    """9 x 7 = 63 pixels split 2, 4 or 8 ways leaves a short last CTA; a
    cluster of 3 splits it evenly."""
    for dtype in (BF16, F32):
        for cb in (32, 64):
            p = instance_norm_forward_plan(2, 64, 9, 7, dtype, cb=cb,
                                           cluster=cluster)
            nps = _check_fwd_plan(p, 2, 64, 63, dtype)
            assert sum(nps) == 63
            assert nps[-1] == 63 - (cluster - 1) * -(-63 // cluster)


def test_k1_forward_plan_of_the_flagship_by_hand():
    """(8, 2048, 32, 32): bf16 in 64-channel chunks, 2 CTAs of 512 pixels a
    slab, 64 KB of x each; f32 the same 64 KB in 4 CTAs of 256 pixels; the
    serving batch of 32 the same clusters (512 and 2048 CTAs fill the card
    already). f32 at 128 x 128 with 32 channels overflows shared memory
    even split 8 ways (2048 pixels x 128 B = 256 KB a CTA): the global
    route; bf16 there takes 128 KB a CTA."""
    p = instance_norm_forward_plan(8, 2048, 32, 32, BF16)
    assert (p.route, p.cb, p.cluster, p.ppc, p.smem, p.grid) == (
        "smem", 64, 2, 512, 65536, (64, 8))
    q = instance_norm_forward_plan(8, 2048, 32, 32, F32)
    assert (q.route, q.cb, q.cluster, q.ppc, q.smem, q.grid) == (
        "smem", 64, 4, 256, 65536, (128, 8))
    for dtype, k in ((BF16, 2), (F32, 4)):
        r = instance_norm_forward_plan(32, 2048, 32, 32, dtype)
        assert (r.cluster, r.smem, r.grid) == (k, 65536, (32 * k, 32))
    g = instance_norm_forward_plan(1, 32, 128, 128, F32)
    assert (g.route, g.cb, g.cluster, g.ppc, g.smem) == (
        "global", 32, 8, 2048, 0)
    assert instance_norm_forward_plan(1, 32, 128, 128, BF16).smem == 131072


def test_k1_forward_static_smem_matches_the_cuda_source():
    """insnorm.cu's forward declares red[1][WARPS][CB], part[2][CB] and
    stat[2][CB] f32 with WARPS = 256 / 32: the plan's fwd_static_smem; and
    the launcher reads the plan the plan's as_ints() writes."""
    src = (CSRC / "insnorm.cu").read_text()
    fwd = src[src.index("instance_norm_kernel(const T*"):
              src.index("instance_norm_backward_kernel(")]
    for decl in ("__shared__ float red[1][WARPS][CB];",
                 "__shared__ float part[2][CB];",
                 "__shared__ float stat[2][CB];"):
        assert decl in fwd
    assert "constexpr int WARPS = kThreads / 32;" in src
    assert fwd_static_smem(64) == (8 + 2 + 2) * 64 * 4
    assert "read_plan(plan, n, B, HW, C, is_bf16 ? 2 : 4, 1, &p)" in src
    assert "read_plan(plan, n, B, HW, C, is_bf16 ? 2 : 4, 2, &p)" in src


def _rank_order_instance_norm(x, cluster, eps=1e-5):
    """The forward kernel's arithmetic in numpy f32 on an NHWC array: each
    (sample, channel)'s H x W split into ``cluster`` parts of ceil(HW /
    cluster) pixels (the last short or empty), each part's sum of x, the
    parts' sums added in rank order for the mean; then each part's sum of
    squared deviations about that mean, added in rank order for the
    variance; rstd = 1 / sqrt(var + eps); y = (x - mean) * rstd."""
    b, h, w, c = x.shape
    hw = h * w
    flat = x.reshape(b, hw, c).astype(np.float32)
    ppc = -(-hw // cluster)
    parts = [flat[:, r * ppc:min(hw, (r + 1) * ppc)] for r in range(cluster)]

    def rank_order(terms):
        t = np.zeros((b, c), np.float32)
        for part in terms:
            t = t + part.sum(axis=1, dtype=np.float32)
        return t

    mean = rank_order(parts) / np.float32(hw)
    var = rank_order([np.square(p - mean[:, None]) for p in parts]) \
        / np.float32(hw)
    rstd = np.float32(1.0) / np.sqrt(var + np.float32(eps))
    return ((flat - mean[:, None]) * rstd[:, None]).reshape(b, h, w, c)


@pytest.mark.parametrize("cluster", [3, 8])
def test_k1_rank_order_two_pass_statistics_match_the_jax_reference(cluster):
    """A ragged split (45 x 47 pixels in 3 parts of 705, or 8 of 265 with
    the last 5 short) of channels of mean 2 and deviation 3 (the JAX
    kernel's test data, tests/test_pallas_insnorm.py): the kernel's
    rank-order two-pass statistics modelled in numpy match
    ``uemda_tpu.models.deeplabv2.instance_norm`` at 1e-5 (f32)."""
    import jax.numpy as jnp

    from uemda_tpu.models.deeplabv2 import instance_norm as jax_instance_norm

    x = np.random.default_rng(cluster).normal(
        2.0, 3.0, size=(2, 45, 47, 64)).astype(np.float32)
    p = instance_norm_forward_plan(2, 64, 45, 47, F32, cluster=cluster)
    assert p.ppc * (cluster - 1) < 45 * 47 <= p.ppc * cluster
    got = _rank_order_instance_norm(x, p.cluster)
    ref = np.asarray(jax_instance_norm(jnp.asarray(x)))
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-5)


# --- K5 / K6 ----------------------------------------------------------------

def _reduce_tiles(p, ids_np, s):
    """segment.cu's K5/K6 CTAs on plan p, in numpy: each tile's pixels once;
    on a table route its window (lowest valid id lo, top id, highest id hi
    below top: rows lo..hi and one for top) when it fits p.rows, else the
    output's atomics. Returns (pixels covered, tiles on the table, the
    windows' row counts, the segment max of ``ids_np`` as the table rows
    would hold it, for values val = ids_np-derived)."""
    b, n = ids_np.shape
    covered = np.zeros((b, n), np.int64)
    on_table, needs = 0, []
    for bi in range(p.grid[1]):
        for bx in range(p.grid[0]):
            p0, p1 = bx * p.tile, min(n, (bx + 1) * p.tile)
            assert p1 > p0
            covered[bi, p0:p1] += 1
            t = ids_np[bi, p0:p1]
            valid = t[(t >= 0) & (t < s)]
            if p.route == "global" or valid.size == 0:
                continue
            lo, top = valid.min(), valid.max()
            below = valid[valid < top]
            hi = below.max() if below.size else lo - 1
            need = hi - lo + 2
            needs.append(need)
            if need <= p.rows:
                on_table += 1
                # every valid id maps to one row in [0, need)
                rows = np.where(valid < top, valid - lo, need - 1)
                assert rows.min() >= 0 and rows.max() < need
                assert len(np.unique(rows)) == len(np.unique(valid))
    return covered, on_table, needs


def _check_reduce_plan(p, b, n, c, s, id_bytes):
    assert p.route in ("full", "window", "global")
    assert p.grid == (-(-n // p.tile), b) and len(p.as_ints()) == 6
    assert p.smem == reduce_smem(p.tile, c, id_bytes, p.rows)
    assert p.smem + segment.REDUCE_STATIC_SMEM <= SMEM_LIMIT
    assert p.rows == {"full": s, "global": 0}.get(p.route, p.rows)
    if p.route == "window":
        assert 1 <= p.rows < s


def _urban_ids(b, seed=0):
    """2urban's stage-2 maps: crops of 512^2 from a 1024^2 grid of
    16-pixel superpixels (ids 0-4095, the boundary pixels 4096)."""
    from uemda_tpu_torch.datasets.synthetic import grid_superpixels

    grid = grid_superpixels(2 * TILE)
    r = np.random.default_rng(seed)
    ys, xs = r.integers(0, TILE + 1, b), r.integers(0, TILE + 1, b)
    return np.stack([grid[y:y + TILE, x:x + TILE].reshape(-1)
                     for y, x in zip(ys, xs)])


@pytest.mark.parametrize("c,ids_dtype", [(7, torch.int32), (6, torch.int32),
                                         (7, torch.int64)])
def test_k5_plan_of_2urban_and_isprs_by_hand(c, ids_dtype):
    """(8, 512^2) values, S 4128: a tile of 32 KB of ids and values (1024
    pixels at C 7 with int32 ids, 1168 at C 6, 904 with int64 ids), a
    window of the 8 KB table's rows (292 at C 7, 341 at C 6), 4 KB a CTA
    more than the staging; every tile of the 2urban maps fits its window,
    which needs at most two rows of 64-wide superpixel ids and the top
    id's row, and every pixel is in one tile."""
    idb = 4 if ids_dtype == torch.int32 else 8
    p = segment_reduce_plan(8, TILE * TILE, c, 4128, ids_dtype)
    tile = {(7, 4): 1024, (6, 4): 1168, (7, 8): 904}[(c, idb)]
    rows = 8192 // (4 * c)
    assert (p.route, p.tile, p.rows, p.grid) == (
        "window", tile, rows, (-(-TILE * TILE // tile), 8))
    _check_reduce_plan(p, 8, TILE * TILE, c, 4128, idb)
    assert p.smem == ((tile * idb + 31) & ~15) + ((tile * c * 4 + 31) & ~15) \
        + rows * c * 4
    ids = _urban_ids(8)
    covered, on_table, needs = _reduce_tiles(p, ids, 4128)
    assert (covered == 1).all()
    assert on_table == p.grid[0] * p.grid[1]
    assert max(needs) <= 64 + 33 + 1


def test_k5_plans_of_random_ids_and_wide_s():
    """Random ids in [0, 4128) overflow every window (each tile holds ~870
    of them); the pinned full table holds all 4128 rows; S x C over the
    shared memory (10000 x 7) keeps the window route, which the 2urban
    maps' ids spread 2x fit; the pinned global route has no table."""
    r = np.random.default_rng(1)
    rnd = r.integers(0, 4128, (2, TILE * TILE))
    p = segment_reduce_plan(2, TILE * TILE, 7, 4128)
    covered, on_table, needs = _reduce_tiles(p, rnd, 4128)
    assert (covered == 1).all() and on_table == 0 and min(needs) > p.rows
    f = segment_reduce_plan(2, TILE * TILE, 7, 4128, route="full")
    _check_reduce_plan(f, 2, TILE * TILE, 7, 4128, 4)
    assert f.rows == 4128 and f.smem == 4128 * 28 + 4128 + 28688 - 16
    covered, on_table, _ = _reduce_tiles(f, rnd, 4128)
    assert (covered == 1).all() and on_table == f.grid[0] * f.grid[1]
    w = segment_reduce_plan(2, TILE * TILE, 7, 10000)
    assert 10000 * 7 * 4 > SMEM_LIMIT and w.route == "window"
    _check_reduce_plan(w, 2, TILE * TILE, 7, 10000, 4)
    _, on_table, _ = _reduce_tiles(w, _urban_ids(2) * 2, 10000)
    assert on_table == w.grid[0] * w.grid[1]
    g = segment_reduce_plan(2, TILE * TILE, 7, 4128, route="global")
    _check_reduce_plan(g, 2, TILE * TILE, 7, 4128, 4)
    assert g.rows == 0 and g.smem == 4128 + 28688 - 16


@pytest.mark.parametrize("b,n,c,s", [(3, 33 * 47, 6, 60), (2, 64 * 96, 7, 25),
                                     (1, 40 * 40, 11, 26), (2, 17 * 15, 1, 21),
                                     (3, 31 * 29, 16, 32), (2, 128 * 128, 7, 9097),
                                     (2, 96 * 128, 7, 1000), (1, 100, 5000, 3)])
@pytest.mark.parametrize("ids_dtype", [torch.int32, torch.int64])
def test_k5_plans_of_the_gpu_test_shapes_cover_every_pixel_once(b, n, c, s,
                                                                ids_dtype):
    idb = 4 if ids_dtype == torch.int32 else 8
    for route in (None, "full", "global"):
        try:
            p = segment_reduce_plan(b, n, c, s, ids_dtype, route=route)
        except ValueError:  # a full table over the shared memory
            assert route == "full" and reduce_smem(
                segment_reduce_plan(b, n, c, s, ids_dtype).tile, c, idb,
                s) > SMEM_LIMIT - segment.REDUCE_STATIC_SMEM
            continue
        _check_reduce_plan(p, b, n, c, s, idb)
        ids = np.random.default_rng(n).integers(-1, s + 1, (b, n))
        covered, _, _ = _reduce_tiles(p, ids, s)
        assert (covered == 1).all()
        if route is None:
            assert p.route == ("full" if s <= max(64, 8192 // (4 * c))
                               else "window")


def test_k5_launcher_bounds_match_the_cuda_source():
    """segment.cu's reduce_smem, thread count, run length and static red
    array are the plan's; its launcher refuses a route without its rows."""
    src = (CSRC / "segment.cu").read_text()
    for text in ("(static_cast<long long>(tile) * id_bytes + 31) & ~15LL",
                 "(static_cast<long long>(tile) * C * 4 + 31) & ~15LL",
                 "return ids + vals + static_cast<long long>(rows) * C * 4;",
                 "constexpr int kThreads = 256;",
                 f"constexpr int kRun = {segment.REDUCE_RUN};",
                 "__shared__ int red[WARPS];",
                 "(route == 2 ? rows != S : route == 1 ? rows < 1 || rows >= S "
                 ": rows != 0)"):
        assert text in src
    assert segment.REDUCE_THREADS == 256
    assert segment.REDUCE_STATIC_SMEM == 4 * 256 // 32
    assert segment.REDUCE_ROUTES == {"full": 2, "window": 1, "global": 0}


# --- K7 ---------------------------------------------------------------------

def _gather_writes(p, b, n, c):
    """How many times segment.cu's K7 writes each output float of a (b, n,
    c) gather under plan p: phase 1 puts lane l of pixel q = t / lanes on
    channels l, l + lanes, ...; the staged route then stores the CTA's run
    of np * c floats from g0 = (b n + p0) c: a head of (4 - g0 % 4) % 4
    floats, 16-byte stores from a 16-byte boundary, and the tail."""
    out = np.zeros(b * n * c, np.int64)
    lanes = p.lanes
    # phase 1 inside one CTA: every (pixel slot, channel) once
    slot = np.zeros((p.ppc, c), np.int64)
    for t in range(segment.GATHER_THREADS):
        slot[t // lanes, t % lanes::lanes] += 1
    assert (slot == 1).all()
    for bi in range(p.grid[1]):
        for bx in range(p.grid[0]):
            p0 = bx * p.ppc
            n_px = min(p.ppc, n - p0)
            assert n_px >= 1
            g0 = (bi * n + p0) * c
            m = n_px * c
            if p.route == "direct":
                out[g0:g0 + m] += 1
                continue
            shift = g0 % 4
            head = min(m, (4 - shift) % 4)
            nv = (m - head) // 4
            tail = head + 4 * nv
            if nv:  # the 16-byte stores and loads on 16-byte boundaries
                assert (g0 + head) % 4 == 0 and (shift + head) % 4 == 0
            assert shift + m <= p.smem // 4
            out[g0:g0 + head] += 1
            out[g0 + head:g0 + tail] += 1
            out[g0 + tail:g0 + m] += 1
    return out


@pytest.mark.parametrize("c", [1, 6, 7, 8, 11, 16])
@pytest.mark.parametrize("b,n", [(8, TILE * TILE), (3, 33 * 47), (2, 257),
                                 (1, 1), (2, 255)])
def test_k7_plans_write_every_pixel_once(b, n, c):
    """N not a multiple of the CTA's pixels (all but 512^2), one pixel, and
    C of 1, 6 (ISPRS), 7 (LoveDA), 8, 11 and 16: every output float of
    every sample written once."""
    p = segment_gather_plan(b, n, c)
    assert p.route == "staged" and p.lanes * p.ppc == segment.GATHER_THREADS
    assert p.grid == (-(-n // p.ppc), b) and len(p.as_ints()) == 6
    assert p.smem == 4 * (p.ppc * c + 4) <= 48 * 1024
    # a lane reads at most 8 channels of its pixel
    assert -(-c // p.lanes) <= 8
    assert p.lanes == 1 or -(-c // (p.lanes // 2)) > 8
    assert (_gather_writes(p, b, n, c) == 1).all()


def test_k7_plan_of_wide_rows_goes_direct():
    """Rows wider than GATHER_STAGED_MAX_C floats: one pixel a CTA, stored
    by its 256 lanes with no staging; up to it, staged."""
    wide = segment.GATHER_STAGED_MAX_C + 452
    p = segment_gather_plan(2, 37, wide)
    assert (p.route, p.lanes, p.ppc, p.smem, p.grid) == (
        "direct", 256, 1, 0, (37, 2))
    assert (_gather_writes(p, 2, 37, wide) == 1).all()
    q = segment_gather_plan(2, 37, segment.GATHER_STAGED_MAX_C)
    assert (q.route, q.lanes, q.ppc) == ("staged", 256, 1)
    assert (_gather_writes(q, 2, 37, segment.GATHER_STAGED_MAX_C) == 1).all()


def test_k7_plan_of_2urban_by_hand():
    """(8, 512^2) ids, 7 classes: one lane a pixel, 256 pixels (7 KB of
    rows) a CTA, 1024 x 8 CTAs."""
    p = segment_gather_plan(8, TILE * TILE, 7)
    assert (p.route, p.lanes, p.ppc, p.smem, p.grid) == (
        "staged", 1, 256, 4 * (256 * 7 + 4), (1024, 8))


def test_sass_parse_counts_loops_and_calls():
    """kernels/sass.py on a cuobjdump listing: a loop from a backward
    branch's target to the branch, a called subroutine up to its RET, the
    self-branch after EXIT not a loop."""
    from uemda_tpu_torch.kernels.sass import parse

    listing = """
        Function : _Z6kernelPfi
        /*0000*/                   MOV R1, c[0x0][0x28] ;
        /*0010*/                   S2R R0, SR_TID.X ;
        /*0020*/                   IMAD R2, R0, 0x4, RZ ;
        /*0030*/                   CALL.REL.NOINC 0x80 ;
        /*0040*/                   ISETP.GE.AND P0, PT, R2, 0x10, PT ;
        /*0050*/              @!P0 BRA 0x20 ;
        /*0060*/                   EXIT ;
        /*0070*/                   BRA 0x70;
        /*0080*/                   IADD3 R3, R3, 0x1, RZ ;
        /*0090*/                   IMAD.HI R3, R3, R2, RZ ;
        /*00a0*/                   RET.REL.NODEC R4 0x0 ;
        /*00b0*/                   NOP ;
        ..........
        Function : _Z5otherv
        /*0000*/                   EXIT ;
"""
    got = parse(listing)
    assert got["_Z6kernelPfi"] == {"insns": 12, "loops": [(0x20, 0x50, 4)],
                                   "calls": [3], "div64": 0}
    assert got["_Z5otherv"] == {"insns": 1, "loops": [], "calls": [],
                                "div64": 0}


def test_sass_parse_counts_64_bit_divisions():
    """A 64-bit division (its I2F.U64.RP, here in a called subroutine) is
    counted; a 32-bit one (I2F.U32.RP) and a plain conversion are not."""
    from uemda_tpu_torch.kernels.sass import parse

    listing = """
        Function : _Z3divPmm
        /*0000*/                   I2F.U32.RP R5, R4 ;
        /*0010*/                   MUFU.RCP R5, R5 ;
        /*0020*/                   I2F.U64 R6, R2 ;
        /*0030*/                   CALL.REL.NOINC 0x50 ;
        /*0040*/                   EXIT ;
        /*0050*/                   I2F.U64.RP R8, R2 ;
        /*0060*/                   MUFU.RCP R8, R8 ;
        /*0070*/                   F2I.U64.TRUNC R10, R8 ;
        /*0080*/                   RET.REL.NODEC R20 0x0 ;
"""
    got = parse(listing)["_Z3divPmm"]
    assert got["div64"] == 1 and got["calls"] == [4]


# --- K3 ---------------------------------------------------------------------

def _src_lo(o, scale, n):
    """tail.cu's src_lo: floor(f32(o * scale)) clamped to the input."""
    f = np.float32(o) * np.float32(scale)
    return min(int(f), n - 1)


def _tail_writes(p, b, hi, wi, ho, wo, nc, elt, base=0):
    """tail.cu's K3 on plan p, CTA by CTA, in numpy: the input window each
    CTA stages (within p.in_rows x p.in_cols); then row by row, each warp's
    chunks of 32 * ppt pixels (warp w on chunks w, w + 8, ... of a row, a
    lane on ppt consecutive pixels), staged in the warp's buffer at the
    chunk's offset within 16 bytes, and the chunk's stores to a destination
    at byte ``base``: the head and tail one element a lane, the rest 16
    bytes a lane, from 16-byte boundaries of the buffer (the warp buffers
    follow the H-rows, the window and the column table in shared memory)
    and of the output. Returns how many times each output pixel (all its
    nc values) was written."""
    v = 16 // elt
    warps = TAIL_THREADS // 32
    chunk = 32 * p.ppt
    cel = tail_chunk_elems(p.ppt, nc, elt)
    # the warp buffers' byte offset in shared memory: the rest of the layout
    out_at = p.smem - warps * cel * elt
    assert out_at % 16 == 0 and out_at >= 8 * p.cols
    writes = np.zeros((b, ho, wo), np.int64)
    sh, sw = tail_scales(hi, wi, ho, wo)
    for gz in range(p.grid[2]):
        c0 = gz * p.cols
        ncol = min(p.cols, wo - c0)
        assert ncol >= 1
        xlo = _src_lo(c0, sw, wi)
        xhi = min(_src_lo(c0 + ncol - 1, sw, wi) + 1, wi - 1)
        assert xhi - xlo + 1 <= p.in_cols
        for gx in range(p.grid[0]):
            r0 = gx * p.rows
            nr = min(p.rows, ho - r0)
            assert nr >= 1
            ylo = _src_lo(r0, sh, hi)
            yhi = min(_src_lo(r0 + nr - 1, sh, hi) + 1, hi - 1)
            assert yhi - ylo + 1 <= p.in_rows
            for bi in range(b):
                for rr in range(nr):
                    for xc in range(0, ncol, chunk):
                        w = (xc // chunk) % warps
                        addr = base + ((bi * ho + r0 + rr) * wo + c0 + xc) \
                            * nc * elt
                        shift = (addr % 16) // elt
                        n = min(chunk, ncol - xc) * nc
                        assert shift + n <= cel  # the lanes' runs
                        head = min(n, (v - shift) % v)
                        nv = (n - head) // v
                        if nv:  # the 16-byte stores
                            assert (addr + head * elt) % 16 == 0
                            assert (out_at + (w * cel + shift + head) * elt) \
                                % 16 == 0
                        assert head + nv * v <= n
                        writes[bi, r0 + rr, c0 + xc:c0 + xc + n // nc] += 1
    return writes


def _check_tail_plan(p, b, hi, wi, ho, wo, g, nc, elt):
    assert p.grid == (-(-ho // p.rows), b, -(-wo // p.cols))
    assert len(p.as_ints()) == 9
    sh, sw = tail_scales(hi, wi, ho, wo)
    assert p.in_rows == min(hi, int((p.rows - 1) * sh) + 4)
    assert p.in_cols == min(wi, int((p.cols - 1) * sw) + 4)
    assert p.smem == tail_smem(p.rows, p.cols, p.ppt, p.in_rows,
                               p.in_cols, g, nc, elt) <= SMEM_LIMIT
    assert p.ppt == (2 if nc in (6, 7) and g == 2 else 1)


# (b, g, nc, hi, ho, wo): serving at batch 8 and 32, the sweep's windows
# (9 windows x 8 views at batch 1 and 4, LoveDA's 7 classes), stage 2's
# evaluation views, and the GPU tests' shapes
TAIL_SHAPES = [(8, 2, 6, 32, 512, 512), (32, 2, 6, 32, 512, 512),
               (72, 2, 6, 32, 512, 512), (288, 2, 7, 32, 512, 512),
               (2, 2, 6, 32, 512, 512), (2, 1, 7, 16, 48, 40),
               (2, 2, 6, 8, 1, 9), (2, 2, 7, 7, 45, 37), (2, 1, 16, 8, 61, 33),
               (2, 3, 6, 16, 100, 100), (1, 2, 17 // 2, 4, 8, 8)]


@pytest.mark.parametrize("b,g,nc,hi,ho,wo", TAIL_SHAPES)
@pytest.mark.parametrize("dtype", [BF16, F32])
def test_k3_plans_write_every_output_once(b, g, nc, hi, ho, wo, dtype):
    """Every output element of every sample written once, every 16-byte
    store on a 16-byte boundary of the staged row and of the output, the
    input windows within the plan's bound, shared memory within 232,448 B;
    at the serving shapes, the sweep's windows and every GPU test's shape
    (an output of one row; rows of 45 x 7 bf16 values that start off 16
    bytes; 16 classes; three heads)."""
    elt = 2 if dtype == BF16 else 4
    p = tail_plan(b, hi, hi, ho, wo, g, nc, dtype)
    _check_tail_plan(p, b, hi, hi, ho, wo, g, nc, elt)
    # the full batch only where it is small: samples repeat the first's
    # pattern when a sample's output is whole 16-byte units
    bb = b if (ho * wo * nc * elt) % 16 else min(b, 2)
    assert (_tail_writes(p, bb, hi, hi, ho, wo, nc, elt) == 1).all()
    # a destination off 16 bytes (a view), and misaligned rows in bf16
    assert (_tail_writes(p, min(b, 2), hi, hi, ho, wo, nc, elt, base=elt)
            == 1).all()


@pytest.mark.parametrize("rows", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("dtype", [BF16, F32])
def test_k3_pinned_plans_of_the_sweep_cover_the_serving_tile(rows, dtype):
    """chip_smoke.py's design sweep at (8, 12, 32, 32) -> 512^2: every
    plan of 1-16 rows a CTA fits and writes every output once."""
    elt = 2 if dtype == BF16 else 4
    p = tail_plan(8, 32, 32, TILE, TILE, 2, 6, dtype, rows=rows)
    _check_tail_plan(p, 8, 32, 32, TILE, TILE, 2, 6, elt)
    assert (p.rows, p.ppt, p.cols) == (rows, 2, TILE)
    assert (_tail_writes(p, 1, 32, 32, TILE, TILE, 6, elt) == 1).all()


def test_k3_plan_of_another_input_size_does_not_fit():
    """The launcher works out the align_corners scales from the call's
    shapes and refuses a plan whose window, shared memory or grid differ
    from the ones they give: a plan made for 16 x 16 logits does not pass
    for 32 x 32 ones with the same output (its window is 16 columns, not
    32), nor one for another batch or output."""
    p = tail_plan(8, 32, 32, TILE, TILE, 2, 6, BF16)
    assert tail_plan(8, 16, 16, TILE, TILE, 2, 6, BF16).as_ints() \
        != p.as_ints()
    assert tail_plan(8, 32, 16, TILE, TILE, 2, 6, BF16).as_ints() \
        != p.as_ints()
    assert tail_plan(4, 32, 32, TILE, TILE, 2, 6, BF16).as_ints() \
        != p.as_ints()
    assert tail_plan(8, 32, 32, TILE // 2, TILE, 2, 6, BF16).as_ints() \
        != p.as_ints()
    src = (CSRC / "tail.cu").read_text()
    assert "int Ho, int Wo, int g, int nc, int is_bf16,\n" in src
    assert "const float sh = scale(Hi, Ho), sw = scale(Wi, Wo);" in src
    assert "in_rows != window_bound(rows, sh, Hi) ||" in src
    assert "in_cols != window_bound(cols, sw, Wi) ||" in src


def test_k3_plan_of_the_flagship_by_hand():
    """(8, 12, 32, 32) bf16 -> 512^2: 8 whole rows a CTA, 2 pixels a
    thread, a window of at most 4 x 32 inputs; shared memory 36 KB of eight
    H-rows (32 columns of 2 heads x logits and steps x 8 padded classes
    and 4 floats of padding, 4 B each), 6 KB of window, 4 KB of column
    table and 8 warps' chunks of 64 pixels x 6 bf16 and 14 of alignment
    slack (392 bf16); 64 x 8 CTAs. Wide outputs split their columns."""
    p = tail_plan(8, 32, 32, TILE, TILE, 2, 6, BF16)
    assert (p.rows, p.cols, p.ppt, p.in_rows, p.in_cols, p.grid) == (
        8, TILE, 2, 4, 32, (64, 8, 1))
    assert p.smem == 8 * 32 * (2 * 2 * 8 + 4) * 4 + 4 * 32 * 12 * 4 \
        + 8 * TILE + 8 * 392 * 2 == 53376
    f = tail_plan(8, 32, 32, TILE, TILE, 2, 6, F32)
    assert (f.rows, f.cols, f.grid) == (8, TILE, (64, 8, 1))
    w = tail_plan(1, 40, 1000, 64, 8000, 2, 16, F32)
    assert w.cols < 8000 and w.grid[2] == -(-8000 // w.cols)
    _check_tail_plan(w, 1, 40, 1000, 64, 8000, 2, 16, 4)
    assert (_tail_writes(w, 1, 40, 1000, 64, 8000, 16, 4) == 1).all()
    assert tail_plan(8, 32, 32, TILE, TILE, 2, 5, BF16).ppt == 1


def _tail_emulated(cat, ho, wo, g, nc, p):
    """tail.cu's arithmetic on plan p in torch, CTA by CTA, on a (B, Hi,
    Wi, g*nc) f32 array: the staged window, the H-lerp of each output row
    and its steps from column to column, the column table, the W-lerp of
    each pixel (an FFMA of lx, the step and the logit), exp2 of an FFMA of
    v * log2e and m * log2e (f64 then rounded, as one FFMA), a reciprocal
    per head times 1/g, and the heads' sum by FFMA. -> (B, Ho, Wo, nc)."""
    x = torch.from_numpy(cat)
    b, hi, wi, gc = x.shape
    f32, log2e = torch.float32, np.float32(1.4426950408889634)
    inv_g = torch.tensor(1.0, dtype=f32) / torch.tensor(float(g), dtype=f32)
    out = torch.empty(b, ho, wo, nc)

    def axis(o0, count, scale, n):
        f = torch.arange(o0, o0 + count, dtype=f32) * torch.tensor(scale, dtype=f32)
        i0 = torch.clamp(f.long(), max=n - 1)
        return i0, torch.clamp(i0 + 1, max=n - 1), f - i0.to(f32)

    sh, sw = tail_scales(hi, wi, ho, wo)
    for gx in range(p.grid[0]):
        r0 = gx * p.rows
        nr = min(p.rows, ho - r0)
        y0, y1, ly = axis(r0, nr, sh, hi)
        ylo = int(y0[0])
        for gz in range(p.grid[2]):
            c0 = gz * p.cols
            ncol = min(p.cols, wo - c0)
            x0, x1, lx = axis(c0, ncol, sw, wi)
            xlo = int(x0[0])
            win = x[:, ylo:, xlo:]                    # the staged window
            ly_, lx_ = ly[None, :, None, None], lx[None, None, :, None]
            hrow = (1 - ly_) * win[:, y0 - ylo] + ly_ * win[:, y1 - ylo]
            step = hrow[:, :, x1 - xlo] - hrow[:, :, x0 - xlo]
            v = (lx_.double() * step.double()
                 + hrow[:, :, x0 - xlo].double()).to(f32)
            acc = torch.zeros(b, nr, ncol, nc, dtype=torch.float64)
            for h in range(g):
                vh = v[..., h * nc:(h + 1) * nc]
                ml = vh.amax(-1, keepdim=True) * log2e
                arg = (vh.double() * float(log2e) - ml.double()).to(f32)
                e = torch.exp2(arg)
                rg = (1 / e.sum(-1, keepdim=True)) * inv_g
                acc = (e.double() * rg.double() + acc).to(f32).double()
            out[:, r0:r0 + nr, c0:c0 + ncol] = acc.to(f32)
    return out.numpy()


@pytest.mark.parametrize("g,nc,hi,ho,wo,rows", [(2, 6, 8, 64, 64, None),
                                                (2, 7, 16, 48, 40, 3),
                                                (1, 6, 8, 32, 32, None),
                                                (3, 6, 5, 29, 37, 5)])
def test_k3_reciprocal_softmax_matches_the_jax_tail(g, nc, hi, ho, wo, rows):
    """The kernel's f32 arithmetic, emulated on its plan, against
    ``uemda_tpu.ops.pallas_tail.tail_upsample_softmax_mean`` in interpret
    mode at atol 1e-5 (the GPU gate): the H-row shared by a CTA's pixels,
    the max folded into the exponent's FFMA, one reciprocal per head."""
    import jax.numpy as jnp

    from uemda_tpu.ops.pallas_tail import tail_upsample_softmax_mean as jax_tail

    rng = np.random.default_rng(g * 100 + nc * 10 + hi)
    cat = (rng.normal(size=(2, hi, hi, g * nc)) * 3).astype(np.float32)
    p = tail_plan(2, hi, hi, ho, wo, g, nc, F32, rows=rows)
    got = _tail_emulated(cat, ho, wo, g, nc, p)
    want = np.asarray(jax_tail(jnp.asarray(cat), (ho, wo), g, nc))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


# --- K8 ---------------------------------------------------------------------

def _probs_t(shape, seed, layout="nchw"):
    b, c, h, w = shape
    r = np.random.default_rng(seed)
    scale = r.choice([0.3, 2.0, 8.0], size=(b, 1, h, w))
    x = torch.from_numpy((r.normal(size=shape) * scale).astype(np.float32))
    p = torch.softmax(x, 1)
    if layout == "channels_last":
        p = p.contiguous(memory_format=torch.channels_last)
    return p


@pytest.mark.parametrize("case,route", [
    ("nchw", "nchw"), ("channels_last", "channels_last"),
    ("rot90", "strided"), ("fp16", "nchw"), ("fp16 channels_last",
                                             "channels_last"),
    ("hw % 4", "strided"), ("misaligned", "strided"), ("C 19", "strided"),
    ("C 1", "strided"), ("C 16", "channels_last")])
def test_k8_route_of_each_layout(case, route):
    """NCHW planes and channels_last memory take the 16-byte routes; a
    rot90 view, H*W not a multiple of 4, a base off 16 bytes (a view one
    pixel in) and C outside 2..16 read through the strides; fp16 is cast
    to f32 first, keeping its layout."""
    shape = {"hw % 4": (2, 7, 37, 53), "C 19": (1, 19, 9, 300),
             "C 1": (2, 1, 8, 8), "C 16": (2, 16, 8, 12)}.get(case,
                                                             (2, 7, 16, 24))
    p = _probs_t(shape, 1, "channels_last" if "channels_last" in case
                 or case in ("rot90", "misaligned", "C 16") else "nchw")
    ptr = 0
    if case == "rot90":
        p = torch.rot90(p, 1, (2, 3))
    elif case.startswith("fp16"):
        p = p.half().float()
    elif case == "misaligned":  # one pixel (7 floats) into a buffer
        flat = torch.empty(p.numel() + 7)
        p = flat[7:].view(2, 16, 24, 7).permute(0, 3, 1, 2)
        ptr = 7 * 4
    b, c, h, w = p.shape
    plan = uvem_mine_plan(b, c, h, w, p.stride(), ptr)
    assert plan.route == route
    ppt = 4 if route == "strided" else mine.MINE_PPT
    assert plan.ppt == ppt
    assert plan.blocks == -(-h * w // (256 * ppt)) and plan.grid == (plan.blocks, b)
    assert plan.smem == (4 * c if route == "strided" else 0)
    assert len(plan.as_ints()) == 5


def test_k8_plan_of_the_flagship_by_hand():
    """(8, 7, 512^2) f32 channels_last: the 16-byte route, 8 pixels a
    thread, 128 CTAs of 256 threads a sample; NCHW planes likewise on their
    route; a base off 16 bytes reads through the strides, 4 pixels a
    thread, its C thresholds in shared memory."""
    cl = (7 * TILE * TILE, 1, 7 * TILE, 7)
    p = uvem_mine_plan(8, 7, TILE, TILE, cl, 0)
    assert (p.route, p.ppt, p.blocks, p.grid, p.smem) == (
        "channels_last", 8, 128, (128, 8), 0)
    assert p.as_ints() == [0, 8, 128, 8, 0]
    n = uvem_mine_plan(8, 7, TILE, TILE, (7 * TILE * TILE, TILE * TILE,
                                          TILE, 1), 0)
    assert (n.route, n.blocks) == ("nchw", 128)
    m = uvem_mine_plan(8, 7, TILE, TILE, cl, 4)
    assert (m.route, m.ppt, m.blocks, m.smem) == ("strided", 4, 256, 28)


def _mine_pixels(plan, b, hw):
    """How many times a pass visits each pixel (both walk the grid alike):
    CTA (bx, by), thread t, iteration i on group q = bx * iters * 256 + i *
    256 + t of 4 pixels (the strided route: q = bx * 256 + t)."""
    seen = np.zeros((b, hw), np.int64)
    iters = plan.ppt // 4
    t = np.arange(MINE_THREADS_)
    for by in range(plan.grid[1]):
        for bx in range(plan.grid[0]):
            for i in range(iters):
                q = bx * iters * 256 + i * 256 + t
                px = (4 * q[:, None] + np.arange(4)).reshape(-1)
                np.add.at(seen[by], px[px < hw], 1)
    return seen


MINE_THREADS_ = 256


@pytest.mark.parametrize("b,c,h,w,layout", [
    (8, 7, TILE, TILE, "channels_last"), (3, 7, 64, 64, "nchw"),
    (2, 6, 37, 53, "nchw"), (1, 19, 9, 300, "nchw"), (2, 7, 40, 48, "nchw")])
@pytest.mark.parametrize("ppt", [None, 4, 16])
def test_k8_plans_visit_every_pixel_once_in_both_passes(b, c, h, w, layout,
                                                        ppt):
    strides = torch.empty(
        (b, c, h, w), device="meta",
        memory_format=torch.channels_last if layout == "channels_last"
        else torch.contiguous_format).stride()
    route = mine.uvem_mine_route(c, h, w, strides, 0)
    if route == "strided" and ppt not in (None, 4):
        with pytest.raises(ValueError, match="pixels a thread"):
            uvem_mine_plan(b, c, h, w, strides, 0, ppt=ppt)
        return
    bb = min(b, 2)
    plan = uvem_mine_plan(bb, c, h, w, strides, 0, ppt=ppt)
    assert plan.route == route
    assert (_mine_pixels(plan, bb, h * w) == 1).all()


def test_k8_launcher_bounds_match_the_cuda_source():
    """mine.cu's thread count, largest C, vector-route class counts and
    pixels a thread, the strided route's shared memory and the plan's int
    layout are ops/mine.py's."""
    src = (CSRC / "mine.cu").read_text()
    for text in ("constexpr int kThreads = 256;",
                 f"constexpr int kMaxC = {mine.MINE_MAX_C};",
                 "!(ppt == 4 || ppt == 8 || ppt == 16) || C < 2 || C > 16",
                 ": ppt != 4 || smem != 4 * C) ||",
                 "!plan || n != 5)",
                 "(route == 0 && (sC != 1 || sW != C || sH != "
                 "static_cast<long long>(W) * C))",
                 "(route == 1 && (sW != 1 || sH != W || sC % 4))",
                 "static_cast<long long>(blocks) * kThreads * ppt < HW",
                 "const int route = plan[0], ppt = plan[1], blocks = plan[2];",
                 "const int smem = plan[4];"):
        assert text in src
    assert [int(n) for n in re.findall(r"UEMDA_MINE\((\d+)\)", src)] == \
        list(mine.MINE_STATIC_C)
    assert mine.MINE_THREADS == MINE_THREADS_ == 256
    assert mine.MINE_ROUTES == {"channels_last": 0, "nchw": 1, "strided": 2}
    tsrc = (CSRC / "tail.cu").read_text()
    assert "constexpr int kThreads = 256;" in tsrc and TAIL_THREADS == 256
    assert "constexpr int kWarps = kThreads / 32;" in tsrc
    assert [tuple(int(v) for v in m) for m in re.findall(
        r"UEMDA_TAIL\((\d+), (\d+), (\d+)\)", tsrc)] == [
        (nc, 2, 2) for nc in TAIL_STATIC_NC] + [(0, 0, 1)]
    assert "ppt != ((nc == 6 || nc == 7) && g == 2 ? 2 : 1) ||" in tsrc


def _mine_emulated(probs, plan, top, low, m, t, gamma, ignore=-1):
    """mine.cu's two passes on plan p in torch f32: pass 1's pixel entropy
    u (each class's p * log(max(p, 1e-30)) added from 0 one class after the
    other, each operation rounded), its per-CTA class maxima over the CTA's
    run of pixels (NaN-propagating) and each pixel's candidate code (the
    one class not at or under f32(low), none, or several) with the
    candidate's value;
    pass 2's reduction of the maxima and its thresholds f32(max * f32(top)),
    NaN kept, else at least f32(low); a pixel's label from its candidate
    (taken if strictly over its threshold), or for several candidates from
    all its classes counted again; w with the branch picked first and one
    pow."""
    b, c, h, w = probs.shape
    flat = probs.reshape(b, c, h * w)
    run = MINE_THREADS_ * plan.ppt
    pad = torch.full((b, c, plan.blocks * run - h * w), float("-inf"))
    part = torch.cat([flat, pad], -1).reshape(b, c, plan.blocks, run).amax(-1)
    x = part.amax(-1) * np.float32(top)
    thr = torch.where(torch.isnan(x), x, torch.clamp(x, min=float(np.float32(low))))
    # pass 1: the candidates
    cand = ~(probs <= float(np.float32(low)))
    count = cand.sum(1)
    cls = torch.where(cand, torch.arange(c)[None, :, None, None], -1).amax(1)
    val = torch.gather(probs, 1, cls.clamp(min=0)[:, None]).squeeze(1)
    # pass 2: one candidate against its threshold; several counted again
    thr_k = torch.gather(thr, 1, cls.clamp(min=0).reshape(b, -1)).reshape(b, h, w)
    one = (count == 1) & (val > thr_k)
    over = probs > thr[:, :, None, None]
    again = (count > 1) & (over.sum(1) == 1)
    idx = torch.where(over, torch.arange(c)[None, :, None, None], -1).amax(1)
    label = torch.full_like(cls, ignore)
    label = torch.where(one, cls, label)
    label = torch.where(again, idx, label).to(torch.int32)
    acc = torch.zeros(b, h, w)
    for k in range(c):
        v = probs[:, k]
        acc = acc + v * torch.log(torch.clamp_min(v, 1e-30))
    u = -acc
    xs = u.clone()
    cs = torch.full_like(u, -1.0 / ((t - m) ** 2) if m < t else 0.0)
    fixed = torch.full_like(u, -1.0)
    nan = torch.isnan(u)
    left = ~nan & (u <= m) & (u < t)
    fixed[left & (m <= 0)] = 1.0
    cs[left] = -1.0 / (m * m) if m > 0 else 0.0
    xs[nan] = 0.0
    if m >= t:
        fixed[nan] = 0.0
    fixed[u >= t] = 0.0
    d = xs - m
    v = torch.clamp(cs * (d * d) + 1.0, 0.0, 1.0) ** (1.0 / gamma)
    return label, torch.where(fixed >= 0, fixed, v), u, count


@pytest.mark.parametrize("layout,shape", [("channels_last", (2, 7, 40, 48)),
                                          ("nchw", (2, 6, 37, 53)),
                                          ("nchw", (1, 19, 9, 300))])
def test_k8_plain_entropy_is_deterministic(layout, shape):
    """The plain version's u, which the K8 emulation is held to bit for
    bit, is the same bits after a JAX computation in this process, with 1,
    2 or 8 torch threads and for contiguous, channels_last and offset
    copies of the probabilities."""
    import jax.numpy as jnp

    float(jnp.log(jnp.linspace(1e-30, 1.0, 1000)).sum())
    p = _probs_t(shape, 5, layout)
    p[1 % shape[0], 3, 5, 6] = float("nan")
    ref = pixel_entropy(p)
    views = [p.contiguous(), p.contiguous(memory_format=torch.channels_last),
             torch.cat([torch.zeros((1,) + p.shape[1:]), p])[1:]]
    threads = torch.get_num_threads()
    try:
        for n in (1, 2, 8):
            torch.set_num_threads(n)
            for v in [p] + views:
                u = pixel_entropy(v)
                assert torch.equal(torch.isnan(u), torch.isnan(ref))
                assert torch.equal(torch.nan_to_num(u), torch.nan_to_num(ref))
    finally:
        torch.set_num_threads(threads)


@pytest.mark.parametrize("m,t", [(0.2, 0.7), (0.0, 0.5), (0.6, 0.5)])
@pytest.mark.parametrize("layout,shape", [("channels_last", (2, 7, 40, 48)),
                                          ("nchw", (2, 6, 37, 53)),
                                          ("nchw", (1, 19, 9, 300))])
@pytest.mark.parametrize("cutoffs", [(0.8, 0.6), (0.4, 0.3)])
def test_k8_two_pass_emulation_is_bit_equal_to_the_plain_version(
        m, t, layout, shape, cutoffs):
    """Block partial maxima, the threshold formed in pass 2, each pixel's
    candidate carried from pass 1 to pass 2 and the one-pow branch
    selection give the plain version's labels and w bit for bit: the three
    branches, the degenerate (m, t) pairs (no left parabola; no right
    one), a NaN probability (its u NaN, its class never selected in its
    sample), one-hot pixels (u = 0) and, at the lowered cutoffs, pixels
    with several candidates. The emulated u is the plain version's bit for
    bit too."""
    top, low = cutoffs
    p = _probs_t(shape, 5, layout)
    p[0, :, 0, 0] = torch.eye(shape[1])[0]
    p[1 % shape[0], 3, 5, 6] = float("nan")
    b, c, h, w = p.shape
    plan = uvem_mine_plan(b, c, h, w, p.stride(), 0)
    ref = uvem_mine_plain(p, top, low, m, t, 4.0)
    got = _mine_emulated(p, plan, top, low, m, t, 4.0)
    assert torch.equal(got[0], ref[0])
    for i in (1, 2):
        assert torch.equal(torch.isnan(got[i]), torch.isnan(ref[i]))
        assert torch.equal(torch.nan_to_num(got[i]), torch.nan_to_num(ref[i]))
    assert bool(torch.isnan(ref[2][1 % b, 5, 6]))
    assert not bool((got[0][1 % b] == 3).any())
    if cutoffs == (0.4, 0.3) and shape[1] < 19:
        assert bool((got[3] > 1).any())  # several candidates: read again