"""Whole-raster sliding-window inference, the raster's rows sharded over
the ranks with a halo exchange.

The port's counterpart of ``uemda_tpu/infer/raster.py`` (the reference
pre-tiles huge scenes offline, ``convert_potsdam.py:35-103``): the padded
raster's rows are cut into equal bands, one a rank (``parallel/``); each
rank runs the sliding-window (+TTA) forward for the window origins in its
band, fetching the ``halo = tile - stride`` rows past its band from the
next rank, and the part of its last windows that falls in the next band
(the "tail") goes to the next rank. Both exchanges are point-to-point
``isend``/``irecv`` (NCCL on the card, gloo on the CPU); no rank holds
another band's activations.

Geometry (:class:`RasterPlan`, the JAX package's): stride =
ceil(tile (1 - overlap)); the raster is zero-padded to ``Hp = N band_h``
rows (``band_h`` a multiple of the stride, at least one window tall,
``Hp >= H + halo``) and ``Wp`` grid-aligned columns; the last rank skips
the window origins past the padded grid's last one.

Exactness: the result equals :func:`uemda_tpu_torch.infer.slide.
make_predictor` over the padded raster, cropped, in every bit the model's
outputs allow. Each pixel's probabilities are summed in the order the
single predictor sums them: a rank first runs the windows that reach
into the next band, sums their tail into a buffer that starts from zeros
and sends it; the next rank starts its canvas's first ``halo`` rows from
that buffer and then adds its own windows in origin order. The overlap
counts are integers, computed once on the host. What can differ is the
model's per-window output itself, when the backend's kernels depend on
the batch they run in: windows go through the model ``window_chunk`` at a
time here, all at once in the single predictor, so one rank with a
``window_chunk`` of all its windows runs the single predictor's batch.
"""

import math
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from uemda_tpu_torch.datasets.augment import normalize
from uemda_tpu_torch.infer.slide import _unviews, _views
from uemda_tpu_torch.parallel import mesh
from uemda_tpu_torch.utils.runtime import resolve_device


class RasterPlan:
    """Static geometry for one (raster_hw, tile, overlap, n_ranks) combo,
    as ``uemda_tpu/infer/raster.py: RasterPlan``."""

    def __init__(self, raster_hw, tile, overlap, n_ranks):
        h, w = raster_hw
        th, tw = tile
        stride = math.ceil(th * (1 - overlap))
        if not 0 < stride <= th:
            raise ValueError(f"overlap {overlap} gives invalid stride {stride}")
        halo = th - stride
        band_h = max(math.ceil(th / stride) * stride,
                     math.ceil((h + halo) / (n_ranks * stride)) * stride)
        self.h, self.w = h, w
        self.th, self.tw, self.stride, self.halo = th, tw, stride, halo
        self.n_ranks = n_ranks
        self.band_h = band_h
        self.hp = n_ranks * band_h
        self.wp = max(tw, math.ceil((w - tw) / stride) * stride + tw) \
            if w > tw else tw
        self.local_ys = list(range(0, band_h, stride))
        self.xs = list(range(0, self.wp - tw + 1, stride))

    def origins(self, last: bool) -> List[Tuple[int, int]]:
        """This band's window origins in the single predictor's order; the
        last rank drops those past the padded grid's last origin."""
        return [(y, x) for y in self.local_ys for x in self.xs
                if not (last and y > self.band_h - self.th)]

    def tail_origins(self, last: bool) -> List[Tuple[int, int]]:
        """The origins whose windows reach past the band (into the next
        band's first ``halo`` rows); none on the last rank."""
        return [] if last else [(y, x) for y, x in self.origins(False)
                                if y + self.th > self.band_h]

    def count_canvas(self, rank: int) -> np.ndarray:
        """(band_h, wp) f32 overlap counts of band ``rank``: its own
        windows and the previous band's tail."""
        last = rank == self.n_ranks - 1
        cnt = np.zeros((self.band_h + self.halo, self.wp), np.float32)
        if rank > 0:
            for y, x in self.tail_origins(False):
                cnt[:y + self.th - self.band_h, x:x + self.tw] += 1.0
        for y, x in self.origins(last):
            cnt[y:y + self.th, x:x + self.tw] += 1.0
        return cnt[:self.band_h]


def _exchange(send: Optional[torch.Tensor], dst: int,
              recv: Optional[torch.Tensor], src: int) -> None:
    """One point-to-point exchange: ``send`` to rank ``dst`` and ``recv``
    from rank ``src`` (either may be None), waited for."""
    ops = []
    if send is not None:
        ops.append(dist.P2POp(dist.isend, send.contiguous(), dst))
    if recv is not None:
        ops.append(dist.P2POp(dist.irecv, recv, src))
    for req in (dist.batch_isend_irecv(ops) if ops else []):
        req.wait()


def make_raster_predictor(
    model: Callable[[torch.Tensor], torch.Tensor],
    raster_hw: Tuple[int, int],
    tile: Tuple[int, int] = (512, 512),
    overlap: float = 0.5,
    tta: bool = False,
    window_chunk: int = 4,
    compute_dtype: torch.dtype = torch.bfloat16,
    return_probs: bool = False,
) -> Callable:
    """Returns ``fn(raster_norm (3, H, W)) -> (H, W) int32 preds`` (or
    ``(C, H, W) f32 probs``), the same on every rank, computed with the
    raster's rows sharded over the ranks (one rank: the whole raster on
    this device). ``model`` as ``make_predictor``'s: (N, 3, th, tw) in
    ``compute_dtype`` -> (N, C, th, tw) probabilities."""
    n, r = mesh.world_size(), mesh.rank()
    plan = RasterPlan(raster_hw, tile, overlap, n)
    th, tw, halo, band_h, wp = plan.th, plan.tw, plan.halo, plan.band_h, \
        plan.wp
    last = r == n - 1
    origins = plan.origins(last)
    tails = plan.tail_origins(last)
    count_np = plan.count_canvas(r)

    def forward(x: torch.Tensor, pts) -> List[torch.Tensor]:
        """(C, th, tw) f32 probabilities of the windows at ``pts``."""
        out = []
        for i in range(0, len(pts), window_chunk):
            tiles = torch.stack([x[:, y:y + th, xx:xx + tw]
                                 for y, xx in pts[i:i + window_chunk]])
            if tta:
                v = _views(tiles)
                p = model(v.reshape((-1,) + v.shape[2:])
                          .contiguous(memory_format=torch.channels_last))
                p = _unviews(p.reshape((8,) + tiles.shape[:1]
                                       + p.shape[1:]).float())
            else:
                p = model(tiles.contiguous(memory_format=torch.channels_last))
            out.extend(p.float().unbind(0))
        return out

    @torch.no_grad()
    def predict(raster: torch.Tensor):
        dev = raster.device
        h, w = raster.shape[1:]
        if (h, w) != (plan.h, plan.w):
            raise ValueError(f"raster {(h, w)} != the plan's "
                             f"{(plan.h, plan.w)}")
        # this rank's band of the zero-padded raster, and the next band's
        # first ``halo`` rows from the next rank
        band = torch.zeros((3, band_h, wp), dtype=compute_dtype, device=dev)
        lo, hi = r * band_h, min((r + 1) * band_h, h)
        if hi > lo:
            band[:, :hi - lo, :w] = raster[:, lo:hi].to(compute_dtype)
        below = torch.zeros((3, halo, wp), dtype=compute_dtype, device=dev)
        if n > 1:
            _exchange(band[:, :halo] if r > 0 else None, r - 1,
                      below if not last else None, r + 1)
        x = torch.cat([band, below], dim=1)

        # the windows that reach into the next band first (their tail,
        # summed from zeros in origin order, goes to the next rank); a band
        # with none (the last, or the only one) runs all its windows here,
        # in the single predictor's batches when ``window_chunk`` covers them
        first = tails or origins
        done = dict(zip(first, forward(x, first)))
        c = next(iter(done.values())).shape[0]
        canvas = torch.zeros((c, band_h, wp), dtype=torch.float32, device=dev)
        if n > 1:
            tail = head = None
            if tails:
                tail = torch.zeros((c, halo, wp), dtype=torch.float32,
                                   device=dev)
                for y, xx in tails:
                    tail[:, :y + th - band_h, xx:xx + tw] += \
                        done[(y, xx)][:, band_h - y:]
            if r > 0:
                head = torch.empty((c, halo, wp), dtype=torch.float32,
                                   device=dev)
            _exchange(tail, r + 1, head, r - 1)
            if head is not None:
                canvas[:, :halo] = head
        rest = [o for o in origins if o not in done]
        done.update(zip(rest, forward(x, rest)))
        for y, xx in origins:
            rows = min(th, band_h - y)
            canvas[:, y:y + rows, xx:xx + tw] += done[(y, xx)][:, :rows]
        probs = canvas / torch.from_numpy(count_np).to(dev)[None]
        out = probs if return_probs else probs.argmax(dim=0).to(torch.int32)
        if n > 1:
            every = mesh.gather_rows(out[None])        # (n, [C,] band_h, wp)
            out = (every.permute(1, 0, 2, 3).reshape(c, n * band_h, wp)
                   if return_probs else every.reshape(n * band_h, wp))
        return out[..., :plan.h, :plan.w]

    predict.plan = plan
    return predict


def raster_predict(model, raster, mean, std, tile: Tuple[int, int] = (512, 512),
                   tta: bool = False, window_chunk: int = 4,
                   compute_dtype: torch.dtype = torch.bfloat16,
                   return_probs: bool = False,
                   predictor: Optional[Callable] = None, device=None):
    """One call: normalize a raw (H, W, 3) raster (numpy or tensor) on
    ``device`` and run the row-sharded predictor (``predictor`` reuses a
    plan)."""
    device = resolve_device(device)
    x = torch.as_tensor(np.asarray(raster)).to(device)
    x = normalize(x.permute(2, 0, 1)[None], mean, std)[0]
    if predictor is None:
        predictor = make_raster_predictor(
            model, tuple(x.shape[1:]), tile=tile, tta=tta,
            window_chunk=window_chunk, compute_dtype=compute_dtype,
            return_probs=return_probs)
    return predictor(x)
