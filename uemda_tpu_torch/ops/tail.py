"""Eval tail: the K3 CUDA kernel, its launch plan and its plain version.

Port of ``uemda_tpu/ops/pallas_tail.py:tail_upsample_softmax_mean``:
bilinear upsample (align_corners=True) of the stacked head logits, f32
softmax per head, mean over the heads (reference ``Encoder.py:152-155``).
Softmax runs on unrounded f32 and the output is rounded once
(``pallas_tail.py:21-24``). The kernel is
``uemda_tpu_torch/kernels/csrc/tail.cu``; each launch runs a plan
(:func:`tail_plan`: pure Python, tested on the CPU), which the launcher
checks against the call's shapes (the launcher works out the align_corners
scales from them). The default plan and its int array are built once per
shape.
"""

import ctypes
import math
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from uemda_tpu_torch import kernels
from uemda_tpu_torch.ops.resblock import SMEM_LIMIT

MAX_CLASSES = 16  # kMaxNC in tail.cu
TAIL_THREADS = 256
TAIL_ROWS = 8    # output rows a CTA, by default
TAIL_STATIC_NC = (6, 7)  # classes of a dual head's compile-time instantiation
_ARGS = [kernels.P, kernels.P] + [kernels.I] * 8 \
    + [kernels.P, kernels.I, kernels.P]


@dataclass(frozen=True)
class TailPlan:
    """One launch of K3: a CTA computes ``rows`` output rows by ``cols``
    output columns of one sample, ``ppt`` consecutive pixels a thread, from
    an input window of at most ``in_rows`` x ``in_cols`` staged in ``smem``
    bytes of shared memory (with the rows H-interpolated, the column table
    and each warp's staged chunk of 32 * ``ppt`` pixels); ``grid``
    (ceil(Ho / rows), B, ceil(Wo / cols))."""
    rows: int
    cols: int
    ppt: int
    in_rows: int
    in_cols: int
    smem: int
    grid: Tuple[int, int, int]

    def as_ints(self):
        """rows, cols, ppt, in_rows, in_cols, smem, grid x, y, z: the int
        array the C launcher takes."""
        return [self.rows, self.cols, self.ppt, self.in_rows, self.in_cols,
                self.smem, *self.grid]


def tail_scales(hi: int, wi: int, ho: int, wo: int) -> Tuple[float, float]:
    """The align_corners scales (in - 1) / (out - 1), 0 for an output of 1,
    rounded to f32 as the launcher computes them."""
    sh = (hi - 1) / (ho - 1) if ho > 1 else 0.0
    sw = (wi - 1) / (wo - 1) if wo > 1 else 0.0
    return float(np.float32(sh)), float(np.float32(sw))


def window_bound(count: int, scale: float, n: int) -> int:
    """tail.cu's window_bound: the input rows (or columns) ``count``
    consecutive outputs read at most. Their first source index is
    floor(o * scale) and their last floor(o' * scale) + 1, each product
    rounded to f32, so they span at most floor((count - 1) * scale) + 4."""
    return min(n, math.floor((count - 1) * scale) + 4)


def tail_chunk_elems(ppt: int, nc: int, elt: int) -> int:
    """Elements of a warp's staged chunk: 32 * ppt pixels of nc values
    plus up to 15 bytes of alignment shift, rounded up to 16 bytes."""
    v = 16 // elt
    return (32 * ppt * nc + 2 * (v - 1)) // v * v


def tail_smem(rows: int, cols: int, ppt: int, in_rows: int, in_cols: int,
              g: int, nc: int, elt: int) -> int:
    """tail.cu's SmemLayout: the CTA's rows H-interpolated ([x][head]
    [logits, steps][nc padded to 4] f32, 16 bytes more a column), the
    staged input window (f32, to 16 bytes), the column table (8 bytes a
    column, to 16 bytes) and each of the TAIL_THREADS / 32 warps' staged
    chunks."""
    ncp = (nc + 3) & ~3
    return (4 * rows * in_cols * (2 * g * ncp + 4)
            + ((4 * in_rows * in_cols * g * nc + 15) & ~15)
            + ((8 * cols + 15) & ~15)
            + TAIL_THREADS // 32 * tail_chunk_elems(ppt, nc, elt) * elt)


def tail_plan(b: int, hi: int, wi: int, ho: int, wo: int, g: int, nc: int,
              dtype: torch.dtype, rows: Optional[int] = None,
              cols: Optional[int] = None) -> TailPlan:
    """The launch plan of K3 for (b, g*nc, hi, wi) logits upsampled to
    (ho, wo) in ``dtype``: TAIL_ROWS whole output rows a CTA (cols = wo);
    columns are halved only if shared memory overflows. 2 pixels a thread
    on a compile-time instantiation (g 2, nc 6 or 7), else 1. ``rows`` and
    ``cols`` pin those choices."""
    if min(b, hi, wi, ho, wo, g, nc) < 1 or b > 65535 or nc > MAX_CLASSES:
        raise ValueError(f"tail_plan: B {b}, in {hi}x{wi}, out {ho}x{wo}, "
                         f"g {g}, nc {nc}")
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"tail_plan: dtype {dtype}")
    elt = 4 if dtype == torch.float32 else 2
    ppt = 2 if g == 2 and nc in TAIL_STATIC_NC else 1
    if rows is None:
        rows = min(TAIL_ROWS, ho)
    sh, sw = tail_scales(hi, wi, ho, wo)

    def smem_of(c):
        return tail_smem(rows, c, ppt, window_bound(rows, sh, hi),
                         window_bound(c, sw, wi), g, nc, elt)

    if cols is None:
        cols = wo
        while cols > 1 and smem_of(cols) > SMEM_LIMIT:
            cols = -(-cols // 2)
    if not (1 <= rows <= ho and 1 <= cols <= wo):
        raise ValueError(f"tail_plan: {rows} rows x {cols} columns a CTA "
                         f"for {ho}x{wo}")
    smem = smem_of(cols)
    if smem > SMEM_LIMIT:
        raise ValueError(f"tail_plan: {smem} B of shared memory for {rows} "
                         f"rows x {cols} columns")
    grid = (-(-ho // rows), b, -(-wo // cols))
    if grid[2] > 65535:
        raise ValueError(f"tail_plan: {grid[2]} column chunks")
    return TailPlan(rows, cols, ppt, window_bound(rows, sh, hi),
                    window_bound(cols, sw, wi), smem, grid)


def tail_upsample_softmax_mean_plain(cat: torch.Tensor, out_hw, g: int,
                                     nc: int) -> torch.Tensor:
    up = F.interpolate(cat.float(), size=tuple(int(s) for s in out_hw),
                       mode="bilinear", align_corners=True)
    probs = sum(torch.softmax(up[:, i * nc:(i + 1) * nc], dim=1)
                for i in range(g)) / g
    return probs.to(cat.dtype).contiguous(memory_format=torch.channels_last)


def tail_upsample_softmax_mean(cat: torch.Tensor, out_hw, g: int, nc: int, *,
                               plan: Optional[TailPlan] = None
                               ) -> torch.Tensor:
    """``cat`` (B, g*nc, Hi, Wi) channels_last -> (B, nc, Ho, Wo)
    channels_last averaged per-head softmax in ``cat.dtype``. A CPU tensor
    takes the plain version; a CUDA tensor launches the kernel on ``plan``
    (default: :func:`tail_plan`'s), kept in
    ``tail_upsample_softmax_mean.plan``; a plan that does not fit the
    call's shapes is refused."""
    b, gc, hi, wi = cat.shape
    if gc != g * nc:
        raise ValueError(f"cat has {gc} channels, expected g*nc={g * nc}")
    if cat.device.type == "cpu":
        return tail_upsample_softmax_mean_plain(cat, out_hw, g, nc)
    kernels.check_cuda_input(cat, "tail cat")
    if nc > MAX_CLASSES:
        raise ValueError(f"tail kernel takes at most {MAX_CLASSES} classes")
    ho, wo = int(out_hw[0]), int(out_hw[1])
    if plan is None:
        plan, arr = kernels.cached_plan(
            ("tail", b, hi, wi, ho, wo, g, nc, cat.dtype),
            lambda: tail_plan(b, hi, wi, ho, wo, g, nc, cat.dtype))
    else:
        arr = kernels.plan_ints(plan)
    out = torch.empty((b, nc, ho, wo), dtype=cat.dtype, device=cat.device,
                      memory_format=torch.channels_last)
    fn = kernels.function("tail", "uemda_tail", _ARGS)
    with kernels.on_device(cat):
        err = fn(cat.data_ptr(), out.data_ptr(), b, hi, wi, ho, wo, g, nc,
                 int(cat.dtype == torch.bfloat16), ctypes.addressof(arr),
                 len(arr), kernels.stream_of(cat))
    kernels.check_launch("tail", "uemda_tail", err)
    tail_upsample_softmax_mean.launches += 1
    tail_upsample_softmax_mean.plan = plan
    return out


tail_upsample_softmax_mean.launches = 0
tail_upsample_softmax_mean.plan = None  # the TailPlan of the last launch
