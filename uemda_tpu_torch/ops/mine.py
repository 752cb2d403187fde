"""Fused uncertainty mining of stage 3: the K8 CUDA kernel and its plain
version.

Port of ``uemda_tpu/ops/pallas_kernels.py:uvem_mine_pallas``: from the
(B, C, H, W) soft label, in one call, the strict-threshold single-class
pseudo label (``ops/pseudo.py:pseudo_selection``), the pixel entropy ``u``
and the UVEM weight ``w`` (``ops/uncertainty.py``), each (B, H, W). The
stage-3 step mines once and hands ``(w, u)`` to both heads' UVEM loss,
where the JAX step takes one selection pass and one entropy + weight pass
per head. Nothing here carries a gradient: ``u`` is a stop-gradient in the
loss and the label is an integer.

The per-(sample, class) threshold max(cutoff_top * class max, cutoff_low)
is the plain version's ``ops/pseudo.py:class_thresholds`` (an f32
multiply, a max, then a strict ``>``); the kernel forms the same f32
values itself from the class maxima of its first pass, so the labels stay
bit-equal; ``amax`` propagates a NaN probability into its class's
threshold, and no pixel then selects that class. The kernel is
``uemda_tpu_torch/kernels/csrc/mine.cu``: two passes launched by one call,
the class max inside them (the first also keeps each pixel's one class over
``cutoff_low``, if any, for the second to test against its threshold), on a
plan (:func:`uvem_mine_plan`: pure Python,
tested on the CPU) that picks the route from the layout: 16-byte loads of
channels_last memory (a rotated, refined soft label arrives so) or of NCHW
planes, or reading through the strides (a ``rot90`` view, odd sizes, other
class counts) -- every layout in place, without a copy. Probabilities in
fp16 or bf16 are cast to f32 first (exact).
"""

import ctypes
import functools
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from uemda_tpu_torch import kernels
from uemda_tpu_torch.ops.pseudo import pseudo_selection
from uemda_tpu_torch.ops.uncertainty import pixel_entropy, uvem_weight

_ARGS = [kernels.P] * 6 + [kernels.I] * 4 + [kernels.L] * 4 \
    + [kernels.F] * 5 + [kernels.I] * 2 + [kernels.F] * 2 \
    + [kernels.I, kernels.P, kernels.I, kernels.P]
MINE_THREADS = 256
MINE_ROUTES = {"channels_last": 0, "nchw": 1, "strided": 2}
MINE_STATIC_C = tuple(range(2, 17))  # class counts compiled into the kernel
MINE_MAX_C = 4096
MINE_PPT = 8  # pixels a thread on the vector routes (4, 8 or 16)


@dataclass(frozen=True)
class MinePlan:
    """One call of K8 (two launches on one grid): ``route``
    "channels_last" or "nchw" (16-byte loads of 4 consecutive pixels,
    compile-time C) or "strided" (through the four strides, 4 pixels a
    thread); ``ppt`` pixels a thread, ``blocks`` CTAs a sample, ``grid``
    (blocks, B), walked in the same order by both passes; ``smem`` bytes of
    dynamic shared memory for pass 2 (the strided route's C thresholds)."""
    route: str
    ppt: int
    blocks: int
    grid: Tuple[int, int]
    smem: int

    def as_ints(self):
        """route (0 channels_last, 1 nchw, 2 strided), ppt, blocks, grid y,
        smem: the int array the C launcher takes."""
        return [MINE_ROUTES[self.route], self.ppt, self.blocks, self.grid[1],
                self.smem]


def uvem_mine_route(c: int, h: int, w: int, strides: Sequence[int],
                    ptr: int) -> str:
    """The vector routes need C in MINE_STATIC_C, H*W a multiple of 4, the
    data 16-byte aligned (``ptr``, its address) and a sample stride of whole
    16 bytes: channels_last memory, or NCHW planes 16 bytes apart; any other
    case reads through the strides."""
    sb, sc, sh, sw = strides
    if c in MINE_STATIC_C and (h * w) % 4 == 0 and ptr % 16 == 0 \
            and sb % 4 == 0:
        if sc == 1 and sw == c and sh == w * c:
            return "channels_last"
        if sw == 1 and sh == w and sc % 4 == 0:
            return "nchw"
    return "strided"


def uvem_mine_plan(b: int, c: int, h: int, w: int, strides: Sequence[int],
                   ptr: int = 0, ppt: Optional[int] = None) -> MinePlan:
    """The launch plan of K8 for (b, c, h, w) f32 probabilities with
    element ``strides`` at address ``ptr``: the route of
    :func:`uvem_mine_route`, MINE_PPT pixels a thread on a vector route (4
    on the strided one). ``ppt`` pins that choice."""
    if min(b, c, h, w) < 1 or b > 65535 or c > MINE_MAX_C \
            or h * w > 0x7ffffff0:
        raise ValueError(f"uvem_mine_plan: B {b}, C {c}, H {h}, W {w}")
    route = uvem_mine_route(c, h, w, strides, ptr)
    if ppt is None:
        ppt = 4 if route == "strided" else MINE_PPT
    if ppt not in ((4,) if route == "strided" else (4, 8, 16)):
        raise ValueError(f"uvem_mine_plan: {ppt} pixels a thread on the "
                         f"{route} route")
    blocks = -(-(h * w) // (MINE_THREADS * ppt))
    return MinePlan(route, ppt, blocks, (blocks, b),
                    4 * c if route == "strided" else 0)


@functools.lru_cache(maxsize=64)
def _mine_consts(cutoff_top, cutoff_low, m, t, gamma):
    """The kernel's f32 scalars: m, t, -1/m^2, -1/(t-m)^2, 1/gamma, whether
    each parabola exists, cutoff_top, cutoff_low -- the plain version's
    Python scalars, each rounded once to f32."""
    f32 = np.float32
    cl = f32(-1.0 / (m * m)) if m > 0 else f32(0.0)
    cr = f32(-1.0 / ((t - m) ** 2)) if m < t else f32(0.0)
    return (float(f32(m)), float(f32(t)), float(cl), float(cr),
            float(f32(1.0 / gamma)), int(m > 0), int(m < t),
            float(f32(cutoff_top)), float(f32(cutoff_low)))


def uvem_mine_plain(probs: torch.Tensor, cutoff_top: float = 0.8,
                    cutoff_low: float = 0.6, m: float = 0.2, t: float = 0.7,
                    gamma: float = 4.0, ignore_label: int = -1
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``pseudo_selection`` + ``pixel_entropy`` + ``uvem_weight``."""
    probs = probs.float()
    label = pseudo_selection(probs, cutoff_top, cutoff_low, ignore_label)
    u = pixel_entropy(probs, dim=1)
    return label, uvem_weight(u, m, t, gamma), u


def uvem_mine(probs: torch.Tensor, cutoff_top: float = 0.8,
              cutoff_low: float = 0.6, m: float = 0.2, t: float = 0.7,
              gamma: float = 4.0, ignore_label: int = -1, *,
              plan: Optional[MinePlan] = None
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(B, C, H, W) probabilities -> (label int32, w f32, u f32), each
    (B, H, W). A CPU tensor takes the plain version; a CUDA tensor, in any
    memory layout, launches K8's two passes on ``plan`` (default:
    :func:`uvem_mine_plan`'s), kept in ``uvem_mine.plan``."""
    if probs.device.type == "cpu":
        return uvem_mine_plain(probs, cutoff_top, cutoff_low, m, t, gamma,
                               ignore_label)
    kernels.check_cuda_input(probs, "uvem_mine probs",
                             dtypes=(torch.float32, torch.float16,
                                     torch.bfloat16),
                             channels_last=None)
    if probs.numel() == 0:
        raise ValueError(f"uvem_mine: empty probabilities {tuple(probs.shape)}")
    probs = probs.float()
    b, c, h, w = probs.shape
    strides = probs.stride()
    if plan is None:
        ptr = probs.data_ptr() % 16
        plan, arr = kernels.cached_plan(
            ("mine", b, c, h, w, strides, ptr),
            lambda: uvem_mine_plan(b, c, h, w, strides, ptr))
    else:
        arr = kernels.plan_ints(plan)
    # label, w and u (each 16-byte aligned when H*W % 4 == 0), pass 1's
    # (B, blocks, C) partial maxima and its candidate code a pixel (bytes)
    # in one allocation
    n = b * h * w
    nt = b * plan.blocks * c
    buf = torch.empty(3 * n + nt + -(-n // 4), dtype=torch.float32,
                      device=probs.device)
    label = buf[:n].view(torch.int32).view(b, h, w)
    wgt, u = buf[n:2 * n].view(b, h, w), buf[2 * n:3 * n].view(b, h, w)
    fn = kernels.function("mine", "uemda_uvem_mine", _ARGS)
    with kernels.on_device(probs):
        err = fn(probs.data_ptr(), buf[3 * n:].data_ptr(),
                 buf[3 * n + nt:].data_ptr(), label.data_ptr(),
                 wgt.data_ptr(), u.data_ptr(), b, c, h, w, *strides,
                 *_mine_consts(cutoff_top, cutoff_low, m, t, gamma),
                 ignore_label, ctypes.addressof(arr), len(arr),
                 kernels.stream_of(probs))
    kernels.check_launch("mine", "uemda_uvem_mine", err)
    uvem_mine.launches += 1
    uvem_mine.plan = plan
    return label, wgt, u


uvem_mine.launches = 0
uvem_mine.plan = None  # the MinePlan of the last call
