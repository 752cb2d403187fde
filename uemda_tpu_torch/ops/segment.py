"""Segment reductions over superpixel id maps: the K5, K6 and K7 CUDA kernels,
their plain versions, and the superpixel view and majority vote built on them.

The port's copy of ``uemda_tpu/ops/segment.py`` (reference
``uemda/gast/alignment.py:175-192,238-250``, which used torch_scatter).
The kernels are ``uemda_tpu_torch/kernels/csrc/segment.cu``:

  * :func:`segment_max` (K5, ``pallas_kernels.py:segment_max_pallas``):
    (B, N, C) f32 values, (B, N) int ids -> (B, S, C) per-segment max;
  * :func:`segment_sum` (K6, ``segment_sum_pallas``): the same under a sum;
  * :func:`segment_gather` (K7, ``segment_gather_pallas``):
    (B, S, C) table, (B, N) ids -> (B, N, C), ``out[b, p] = seg[b, ids[b, p]]``,
    an exact indexed load (never a one-hot product).

The JAX package has two routes that differ at the edges; the port follows
its default one (``superpixel_view_probs(impl="auto")``: ``jax.ops``
segment reductions and ``take_along_axis``), not the Pallas kernels:

  * an empty segment holds -inf under the max (the Pallas kernel: -3e38)
    and 0 under the sum;
  * an id >= S is left out of both reductions, and gathers back NaN (the
    Pallas kernel: 0). A negative id is treated the same way here, where
    ``take_along_axis`` would wrap it; superpixel maps are unsigned, so it
    never occurs. No kernel reads or writes out of bounds for such an id.

Superpixel ids are numbered over the whole image before the crop, and the
top id marks the shrunk boundary pixels (``uemda/gast/superpixels.py:
129-152``); ``max_segments`` bounds max(id) + 1.

Each launch runs a plan (:func:`segment_reduce_plan` for K5 and K6,
:func:`segment_gather_plan` for K7; pure Python, tested on the CPU); the
launcher checks it. Each default plan and its int array are built once per
shape.
"""

import ctypes
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from uemda_tpu_torch import kernels
from uemda_tpu_torch.ops.labels import one_hot_ignore
from uemda_tpu_torch.ops.resblock import SMEM_LIMIT

_REDUCE_ARGS = [kernels.P, kernels.P, kernels.I, kernels.P] + [kernels.I] * 5 \
    + [kernels.P, kernels.I, kernels.P]
_GATHER_ARGS = [kernels.P, kernels.P, kernels.I, kernels.P] + [kernels.I] * 4 \
    + [kernels.P, kernels.I, kernels.P]
GATHER_THREADS = 256
GATHER_STAGED_MAX_C = 2048  # wider rows go straight to the output
REDUCE_THREADS = 256
REDUCE_RUN = 7              # pixels a thread folds before an atomic
REDUCE_STAGE_BYTES = 32 * 1024  # ids and values a CTA stages
REDUCE_TABLE_BYTES = 8 * 1024   # the table of a "window" plan
REDUCE_MIN_ROWS = 64            # the least window worth a table
REDUCE_ROUTES = {"full": 2, "window": 1, "global": 0}
REDUCE_STATIC_SMEM = 4 * REDUCE_THREADS // 32  # the kernel's red[WARPS]


@dataclass(frozen=True)
class ReducePlan:
    """One launch of K5 or K6: a CTA stages ``tile`` pixels (their ids and
    values) and reduces them into a table of ``rows`` rows of C floats in
    shared memory, ``smem`` bytes in all; ``grid`` (ceil(N / tile), B).
    Route "full": S rows, every tile's ids fit; "window": fewer rows, and a
    tile whose ids span more (lowest to highest below its top id, plus the
    top id's row) reduces straight into the output; "global": no table,
    every tile reduces into the output with global atomics."""
    route: str
    tile: int
    rows: int
    smem: int
    grid: Tuple[int, int]

    def as_ints(self):
        """route (2 full, 1 window, 0 global), tile, rows, smem, grid x, y:
        the int array the C launcher takes."""
        return [REDUCE_ROUTES[self.route], self.tile, self.rows, self.smem,
                *self.grid]


def reduce_smem(tile: int, c: int, id_bytes: int, rows: int) -> int:
    """segment.cu's reduce_smem: the staged ids and values, each with 16
    bytes of slack for its alignment shift and rounded up to 16 bytes, and
    the table."""
    return (((tile * id_bytes + 31) & ~15) + ((tile * c * 4 + 31) & ~15)
            + rows * c * 4)


def segment_reduce_plan(b: int, n: int, c: int, s: int,
                        ids_dtype: torch.dtype = torch.int32,
                        route: Optional[str] = None,
                        tile: Optional[int] = None) -> ReducePlan:
    """The launch plan of K5/K6 for (b, n, c) values and ``s`` segments: a
    tile of REDUCE_STAGE_BYTES of ids and values (a multiple of 8 pixels,
    at most N rounded up to 8); a table of the rows that fill
    REDUCE_TABLE_BYTES, at least REDUCE_MIN_ROWS: S rows where S is no more
    ("full"), else that many ("window"); "global" where table and tile
    overflow the shared memory. ``route`` and ``tile`` pin those choices.
    No rule reads the card's SM count: 1024-pixel tiles give the 2urban
    batch 2048 CTAs."""
    if min(b, n, c, s) < 1 or b > 65535 or s * c > 1 << 30:
        raise ValueError(f"segment_reduce_plan: B {b}, N {n}, C {c}, S {s}")
    if ids_dtype not in (torch.int32, torch.int64):
        raise TypeError(f"segment_reduce_plan: ids dtype {ids_dtype}")
    idb = 4 if ids_dtype == torch.int32 else 8
    if tile is None:
        tile = min(max(8, REDUCE_STAGE_BYTES // (4 * c + idb) // 8 * 8),
                   -(-n // 8) * 8)
    if tile < 1:
        raise ValueError(f"segment_reduce_plan: tile {tile}")
    rows = max(REDUCE_MIN_ROWS, REDUCE_TABLE_BYTES // (4 * c))
    if route is None:
        route = "full" if rows >= s else "window"
        if (reduce_smem(tile, c, idb, min(rows, s)) + REDUCE_STATIC_SMEM
                > SMEM_LIMIT):
            route = "global"
    if route not in REDUCE_ROUTES or (route == "window" and rows >= s):
        raise ValueError(f"segment_reduce_plan: route {route} for S {s}")
    rows = {"full": s, "window": rows, "global": 0}[route]
    smem = reduce_smem(tile, c, idb, rows)
    if smem + REDUCE_STATIC_SMEM > SMEM_LIMIT:
        raise ValueError(f"segment_reduce_plan: {smem} B of shared memory "
                         f"for a tile of {tile} pixels of {c} channels, "
                         f"{rows} rows")
    return ReducePlan(route, tile, rows, smem, (-(-n // tile), b))


@dataclass(frozen=True)
class GatherPlan:
    """One launch of K7: ``lanes`` threads a pixel, ``ppc`` = 256 / lanes
    pixels a CTA, ``grid`` (ceil(N / ppc), B); route "staged" (the CTA's
    rows through ``smem`` bytes of shared memory, stored 16 bytes at a time)
    or "direct" (one pixel a CTA, rows stored by the lanes, no shared
    memory)."""
    route: str
    lanes: int
    ppc: int
    smem: int
    grid: Tuple[int, int]

    def as_ints(self):
        """lanes, ppc, smem, route (1 staged, 0 direct), grid x, y: the int
        array the C launcher takes."""
        return [self.lanes, self.ppc, self.smem, int(self.route == "staged"),
                *self.grid]


def segment_gather_plan(b: int, n: int, c: int) -> GatherPlan:
    """The launch plan of K7 for (b, n) ids and c channels: one lane a pixel
    up to 8 channels, then the power of two that gives each lane at most 8
    (256 at most); rows up to GATHER_STAGED_MAX_C floats are staged."""
    if min(b, n, c) < 1 or b > 65535:
        raise ValueError(f"segment_gather_plan: B {b}, N {n}, C {c}")
    lanes = min(GATHER_THREADS, 1 << max(0, -(-c // 8) - 1).bit_length())
    ppc = GATHER_THREADS // lanes
    grid = (-(-n // ppc), b)
    if c > GATHER_STAGED_MAX_C:
        return GatherPlan("direct", lanes, ppc, 0, grid)
    return GatherPlan("staged", lanes, ppc, 4 * (ppc * c + 4), grid)


def _in_range(ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    return (ids >= 0) & (ids < num_segments)


def _segment_reduce_plain(data, ids, num_segments, reduce, empty):
    """scatter_reduce over S + 1 buckets; out-of-range ids go to the last,
    which is dropped."""
    b, n, c = data.shape
    idx = torch.where(_in_range(ids, num_segments), ids.long(),
                      torch.full_like(ids, num_segments, dtype=torch.long))
    out = torch.full((b, num_segments + 1, c), empty, dtype=torch.float32,
                     device=data.device)
    out.scatter_reduce_(1, idx[..., None].expand(b, n, c), data.float(),
                        reduce=reduce, include_self=True)
    return out[:, :num_segments]


def segment_max_plain(data: torch.Tensor, ids: torch.Tensor,
                      num_segments: int) -> torch.Tensor:
    return _segment_reduce_plain(data, ids, num_segments, "amax",
                                 float("-inf"))


def segment_sum_plain(data: torch.Tensor, ids: torch.Tensor,
                      num_segments: int) -> torch.Tensor:
    return _segment_reduce_plain(data, ids, num_segments, "sum", 0.0)


def segment_sum_bound(data: torch.Tensor, ids: torch.Tensor,
                      num_segments: int):
    """The exact sums (f64) and the error bound of any f32 summation order,
    count * 2^-24 * sum |x| per segment: what K6's atomics, whose order
    varies from run to run, are held to on non-integer values."""
    b, n, c = data.shape
    idx = torch.where(_in_range(ids, num_segments), ids.long(),
                      torch.full_like(ids, num_segments, dtype=torch.long))
    idx = idx[..., None].expand(b, n, c)

    def add(v):
        out = torch.zeros((b, num_segments + 1, c), dtype=torch.float64,
                          device=data.device)
        return out.scatter_add_(1, idx, v.double())[:, :num_segments]

    exact = add(data)
    bound = add(torch.ones_like(data)) * 2.0 ** -24 * add(data.abs())
    return exact, bound


def segment_gather_plain(seg: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    b, s, c = seg.shape
    valid = _in_range(ids, s)
    idx = torch.where(valid, ids.long(), torch.zeros_like(ids, dtype=torch.long))
    out = torch.gather(seg.float(), 1, idx[..., None].expand(b, ids.shape[1], c))
    return torch.where(valid[..., None], out, torch.full_like(out, float("nan")))


def _check(t: torch.Tensor, name: str, ndim: int, dtypes) -> None:
    kernels.check_cuda_input(t, name, ndim=ndim, dtypes=dtypes,
                             channels_last=False)


def _check_ids(data: torch.Tensor, ids: torch.Tensor, name: str) -> None:
    _check(ids, f"{name} ids", 2, (torch.int32, torch.int64))
    if ids.device != data.device or tuple(ids.shape) != tuple(data.shape[:2]):
        raise ValueError(f"{name}: ids {tuple(ids.shape)} on {ids.device} do "
                         f"not match {tuple(data.shape)} on {data.device}")


def _reduce(data, ids, num_segments, is_max, name, plan):
    _check(data, f"{name} data", 3, (torch.float32,))
    _check_ids(data, ids, name)
    b, n, c = data.shape
    s = int(num_segments)
    if plan is None:
        plan, arr = kernels.cached_plan(
            ("reduce", b, n, c, s, ids.dtype),
            lambda: segment_reduce_plan(b, n, c, s, ids.dtype))
    else:
        arr = kernels.plan_ints(plan)
    out = torch.empty((b, s, c), dtype=torch.float32, device=data.device)
    fn = kernels.function("segment", "uemda_segment_reduce", _REDUCE_ARGS)
    with kernels.on_device(data):
        err = fn(data.data_ptr(), ids.data_ptr(), int(ids.dtype == torch.int64),
                 out.data_ptr(), b, n, c, s, int(is_max),
                 ctypes.addressof(arr), len(arr), kernels.stream_of(data))
    kernels.check_launch("segment", "uemda_segment_reduce", err)
    return out, plan


def segment_max(data: torch.Tensor, ids: torch.Tensor, num_segments: int, *,
                plan: ReducePlan = None) -> torch.Tensor:
    """Batched segment max: data (B, N, C) f32, ids (B, N) int32/int64 ->
    (B, S, C) f32, -inf for an empty segment. A CPU tensor takes the plain
    version; a CUDA tensor launches K5 on ``plan`` (default:
    :func:`segment_reduce_plan`'s), kept in ``segment_max.plan``; its route
    ("full", "window" or "global") in ``segment_max.route``."""
    if data.device.type == "cpu":
        return segment_max_plain(data, ids, num_segments)
    out, p = _reduce(data, ids, num_segments, True, "segment_max", plan)
    segment_max.plan, segment_max.route = p, p.route
    segment_max.launches += 1
    return out


def segment_sum(data: torch.Tensor, ids: torch.Tensor, num_segments: int, *,
                plan: ReducePlan = None) -> torch.Tensor:
    """Batched segment sum: data (B, N, C) f32, ids (B, N) -> (B, S, C) f32,
    0 for an empty segment. A CPU tensor takes the plain version; a CUDA
    tensor launches K6 on ``plan`` (as :func:`segment_max`; plan and route
    in ``segment_sum.plan`` and ``segment_sum.route``)."""
    if data.device.type == "cpu":
        return segment_sum_plain(data, ids, num_segments)
    out, p = _reduce(data, ids, num_segments, False, "segment_sum", plan)
    segment_sum.plan, segment_sum.route = p, p.route
    segment_sum.launches += 1
    return out


def segment_gather(seg: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Gather-back: seg (B, S, C) f32, ids (B, N) -> (B, N, C) f32,
    ``out[b, p] = seg[b, ids[b, p]]``, NaN for an id outside [0, S). A CPU
    tensor takes the plain version; a CUDA tensor launches K7 (its plan in
    ``segment_gather.plan``)."""
    if seg.device.type == "cpu":
        return segment_gather_plain(seg, ids)
    _check(seg, "segment_gather seg", 3, (torch.float32,))
    _check(ids, "segment_gather ids", 2, (torch.int32, torch.int64))
    if ids.device != seg.device or ids.shape[0] != seg.shape[0]:
        raise ValueError(f"segment_gather: ids {tuple(ids.shape)} on "
                         f"{ids.device} do not match {tuple(seg.shape)} on "
                         f"{seg.device}")
    b, s, c = seg.shape
    n = ids.shape[1]
    plan, arr = kernels.cached_plan(("gather", b, n, c),
                                    lambda: segment_gather_plan(b, n, c))
    out = torch.empty((b, n, c), dtype=torch.float32, device=seg.device)
    fn = kernels.function("segment", "uemda_segment_gather", _GATHER_ARGS)
    with kernels.on_device(seg):
        err = fn(seg.data_ptr(), ids.data_ptr(), int(ids.dtype == torch.int64),
                 out.data_ptr(), b, n, c, s, ctypes.addressof(arr), len(arr),
                 kernels.stream_of(seg))
    kernels.check_launch("segment", "uemda_segment_gather", err)
    segment_gather.launches += 1
    segment_gather.plan = plan
    return out


segment_max.launches = segment_sum.launches = segment_gather.launches = 0
segment_max.route = segment_sum.route = None
segment_max.plan = segment_sum.plan = None  # the ReducePlan of the last launch
segment_gather.plan = None  # the GatherPlan of the last launch


def _flat_ids(sup: torch.Tensor) -> torch.Tensor:
    b = sup.shape[0]
    ids = sup.reshape(b, -1)
    if ids.dtype not in (torch.int32, torch.int64):
        ids = ids.to(torch.int32)
    return ids.contiguous()


def superpixel_view_probs(probs: torch.Tensor, sup: torch.Tensor,
                          max_segments: int) -> torch.Tensor:
    """Per-pixel class probabilities pooled by max over the pixel's
    superpixel (``alignment.py:238-250``): K5 then K7.

    probs: (B, C, H, W) soft labels (channels_last, so the (B, H*W, C) view
    the kernels read is free); sup: (B, H, W) int ids. Returns
    (B, C, H, W) channels_last in probs' dtype."""
    b, c, h, w = probs.shape
    flat = probs.float().permute(0, 2, 3, 1).reshape(b, h * w, c).contiguous()
    ids = _flat_ids(sup)
    pooled = segment_max(flat, ids, max_segments)          # (B, S, C)
    out = segment_gather(pooled, ids)                      # (B, H*W, C)
    return out.reshape(b, h, w, c).permute(0, 3, 1, 2).to(probs.dtype)


def superpixel_expand(label_hard: torch.Tensor, sup: torch.Tensor,
                      num_classes: int, max_segments: int,
                      ignore_label: int = -1) -> torch.Tensor:
    """Expand hard labels to whole superpixels by majority vote
    (``Aligner.superpixel_expand``, ``alignment.py:175-192``): K6 counts
    the one-hot labels per superpixel; the winner (the lower class on a
    tie; ignore where the superpixel holds no labelled pixel) is gathered
    back. A pixel whose id is >= max_segments gets the int32 minimum, as
    ``take_along_axis`` fills an int gather."""
    b, h, w = label_hard.shape
    oh = one_hot_ignore(label_hard, num_classes, ignore_label)
    ids = _flat_ids(sup)
    counts = segment_sum(oh.reshape(b, h * w, num_classes), ids, max_segments)
    best, win = counts.max(dim=-1)
    win = torch.where(best == 0, torch.full_like(win, ignore_label), win)
    valid = _in_range(ids, max_segments)
    idx = torch.where(valid, ids.long(), torch.zeros_like(ids, dtype=torch.long))
    out = torch.gather(win, 1, idx).to(torch.int32)
    out = torch.where(valid, out,
                      torch.full_like(out, torch.iinfo(torch.int32).min))
    return out.reshape(b, h, w)
