"""Launch plans of the port's redesigned kernels, on the CPU: K4's
(``ops/resblock.py: bottleneck_plan``) and K2's (``ops/stem.py:
stem_plan``). Every identity bottleneck of ResNet-50 and ResNet-101 at
output stride 8 and 16 on 512^2 tiles, and every shape the GPU tests run,
gets a plan that fits the H100's 232,448 bytes of shared memory a block; the
wgmma path's haloed and output tiles fit its 64-row m-tiles; the plan's
shared-memory layout holds every operand the kernel reads where it reads it,
with every TMA destination on its swizzle's period; the grid covers every
output pixel once. The CUDA launchers check the plans' bounds again on the
card."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from uemda_tpu_torch import kernels
from uemda_tpu_torch.models.resnet import RESNET_SPECS, stage_plan
from uemda_tpu_torch.ops import resblock, stem
from uemda_tpu_torch.ops.resblock import (
    SMEM_LIMIT,
    WGMMA_CONFIGS,
    bottleneck_plan,
    wgmma_layout,
)
from uemda_tpu_torch.ops.stem import stem_plan

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
