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
"""

import ctypes

import torch

from uemda_tpu_torch import kernels
from uemda_tpu_torch.ops.labels import one_hot_ignore

_REDUCE_ARGS = [kernels.P, kernels.P, kernels.I, kernels.P, kernels.I,
                kernels.I, kernels.I, kernels.I, kernels.I,
                ctypes.POINTER(ctypes.c_int), kernels.P]
_GATHER_ARGS = [kernels.P, kernels.P, kernels.I, kernels.P] + [kernels.I] * 4 \
    + [kernels.P]


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


def _reduce(data, ids, num_segments, is_max, name):
    _check(data, f"{name} data", 3, (torch.float32,))
    _check_ids(data, ids, name)
    b, n, c = data.shape
    out = torch.empty((b, num_segments, c), dtype=torch.float32,
                      device=data.device)
    route = ctypes.c_int(-1)
    fn = kernels.function("segment", "uemda_segment_reduce", _REDUCE_ARGS)
    with torch.cuda.device(data.device):
        err = fn(data.data_ptr(), ids.data_ptr(), int(ids.dtype == torch.int64),
                 out.data_ptr(), b, n, c, int(num_segments), int(is_max),
                 ctypes.byref(route), kernels.stream_of(data))
    kernels.check_launch("segment", "uemda_segment_reduce", err)
    return out, "shared" if route.value == 1 else "global"


def segment_max(data: torch.Tensor, ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """Batched segment max: data (B, N, C) f32, ids (B, N) int32/int64 ->
    (B, S, C) f32, -inf for an empty segment. A CPU tensor takes the plain
    version; a CUDA tensor launches K5 (its route, "shared" or "global",
    is kept in ``segment_max.route``)."""
    if data.device.type == "cpu":
        return segment_max_plain(data, ids, num_segments)
    out, segment_max.route = _reduce(data, ids, num_segments, True,
                                     "segment_max")
    segment_max.launches += 1
    return out


def segment_sum(data: torch.Tensor, ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """Batched segment sum: data (B, N, C) f32, ids (B, N) -> (B, S, C) f32,
    0 for an empty segment. A CPU tensor takes the plain version; a CUDA
    tensor launches K6 (route in ``segment_sum.route``)."""
    if data.device.type == "cpu":
        return segment_sum_plain(data, ids, num_segments)
    out, segment_sum.route = _reduce(data, ids, num_segments, False,
                                     "segment_sum")
    segment_sum.launches += 1
    return out


def segment_gather(seg: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Gather-back: seg (B, S, C) f32, ids (B, N) -> (B, N, C) f32,
    ``out[b, p] = seg[b, ids[b, p]]``, NaN for an id outside [0, S). A CPU
    tensor takes the plain version; a CUDA tensor launches K7."""
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
    out = torch.empty((b, n, c), dtype=torch.float32, device=seg.device)
    fn = kernels.function("segment", "uemda_segment_gather", _GATHER_ARGS)
    with torch.cuda.device(seg.device):
        err = fn(seg.data_ptr(), ids.data_ptr(), int(ids.dtype == torch.int64),
                 out.data_ptr(), b, n, c, s, kernels.stream_of(seg))
    kernels.check_launch("segment", "uemda_segment_gather", err)
    segment_gather.launches += 1
    return out


segment_max.launches = segment_sum.launches = segment_gather.launches = 0
segment_max.route = segment_sum.route = None


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
