"""Data parallelism over ``torch.distributed``: this rank's place in the
group and the collectives the train steps take.

The port's counterpart of ``uemda_tpu/parallel/mesh.py``. The JAX package
runs one SPMD program over a 1-D device mesh: the batch is sharded along
its leading axis, the state replicated, and XLA makes every reduction over
the batch global without any code saying so. Here each rank is one
process driving one device (``cuda:<local rank>`` on NCCL, the CPU on
gloo), the ranks hold consecutive rows of every global batch (rank r rows
``[r b, (r + 1) b)`` of ``N b``), and each reduction over the batch says
so through the helpers below. Under them a run at N ranks does the math of
one rank at the global batch.

The gradient convention: every function of the batch returns its global
value on every rank (a loss is replicated); :func:`gsum` all-reduces in
its forward and all-reduces the incoming gradient in its backward (the
transpose of a sum over ranks); a step backpropagates ``loss / N``
(:func:`backward`), so that each activation receives the true gradient of
the global loss, and the optimizers sum the parameters' gradients over the
ranks (:func:`all_reduce_grads`). BatchNorm in training mode normalizes
with the global batch's statistics (:func:`batch_norm`, one autograd
function whose forward gathers each rank's count, mean and centred sum of
squares in one collective, and whose backward all-reduces the two
gradient sums in one).

At world size 1 (no process group, or a group of one) every helper is the
identity or the plain expression it replaces, and launches nothing.
"""

import functools
import inspect
from typing import Iterable, Optional, Tuple

import torch
import torch.distributed as dist


def world_size() -> int:
    """The number of data-parallel ranks: the default group's size, 1
    without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def rank() -> int:
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def backend() -> Optional[str]:
    """The default group's backend ('nccl', 'gloo'), None without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_backend()
    return None


def rows(local_batch: int) -> slice:
    """This rank's rows of a global batch of ``local_batch`` x N rows."""
    r = rank()
    return slice(r * local_batch, (r + 1) * local_batch)


def shard_rows(x: torch.Tensor) -> torch.Tensor:
    """This rank's rows of a tensor drawn for the global batch (dim 0)."""
    n = world_size()
    if n == 1:
        return x
    if x.shape[0] % n:
        raise ValueError(f"global batch {x.shape[0]} not divisible by {n} "
                         "ranks")
    return x[rows(x.shape[0] // n)]


class _AllReduceSum(torch.autograd.Function):
    """Sum over the ranks; the backward sums the incoming gradient."""

    @staticmethod
    def forward(ctx, x):
        y = x.clone()
        dist.all_reduce(y)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g)
        return g


def gsum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the ranks (a sum or a count of local rows), on
    every rank; differentiable (module docstring)."""
    if world_size() == 1:
        return x
    if x.requires_grad:
        return _AllReduceSum.apply(x)
    y = x.clone()
    dist.all_reduce(y)
    return y


def gmax(x: torch.Tensor) -> torch.Tensor:
    """The elementwise maximum over the ranks (no gradient)."""
    if world_size() == 1:
        return x
    y = x.detach().clone()
    dist.all_reduce(y, op=dist.ReduceOp.MAX)
    return y


def gmean(x: torch.Tensor) -> torch.Tensor:
    """The mean of ``x`` over all elements of the global batch (every rank
    holds the same number): ``x.mean()`` at world size 1."""
    n = world_size()
    if n == 1:
        return x.mean()
    return gsum(x.sum()) / (x.numel() * n)


def _all_gather(x: torch.Tensor) -> torch.Tensor:
    out = torch.empty((world_size() * x.shape[0],) + tuple(x.shape[1:]),
                      dtype=x.dtype, device=x.device)
    # all_gather_single in newer PyTorch, all_gather_into_tensor before
    gather = getattr(dist, "all_gather_single", None) \
        or dist.all_gather_into_tensor
    gather(out, x.contiguous())
    return out


class _GatherRows(torch.autograd.Function):
    """The ranks' tensors concatenated along dim 0 in rank order; the
    backward sums the gradient over the ranks and keeps this rank's rows."""

    @staticmethod
    def forward(ctx, x):
        ctx.rows = rows(x.shape[0])
        return _all_gather(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g)
        return g[ctx.rows]


def gather_rows(x: torch.Tensor) -> torch.Tensor:
    """The global batch's rows of ``x`` (dim 0), on every rank: what one
    rank at the global batch holds. Differentiable."""
    if world_size() == 1:
        return x
    if x.requires_grad:
        return _GatherRows.apply(x)
    return _all_gather(x)


def global_batch(*names: str):
    """Decorator for a function of whole-batch tensors (pairwise distances,
    a top-k or a permutation over every row): at world size > 1 its
    arguments ``names`` are gathered (:func:`gather_rows`) and it runs on
    the global batch, as one rank would; its result is replicated."""
    def wrap(fn):
        sig = inspect.signature(fn)

        @functools.wraps(fn)
        def inner(*args, **kwargs):
            if world_size() == 1:
                return fn(*args, **kwargs)
            bound = sig.bind(*args, **kwargs)
            for n in names:
                if bound.arguments.get(n) is not None:
                    bound.arguments[n] = gather_rows(bound.arguments[n])
            return fn(*bound.args, **bound.kwargs)
        return inner
    return wrap


def halves(b: int) -> Tuple[slice, slice]:
    """This rank's rows (of ``b``) that lie in the global batch's first
    half and those in its second (``x[:B // 2]`` and ``x[B // 2:]`` of the
    global batch of ``B``): two slices, since the ranks' rows are
    consecutive."""
    k = min(max((b * world_size()) // 2 - rank() * b, 0), b)
    return slice(0, k), slice(k, b)


def backward(loss: torch.Tensor) -> None:
    """Backpropagate the replicated global ``loss`` as this rank's share
    (``loss / N``): each activation then receives the true gradient of the
    global loss and :func:`all_reduce_grads` sums the parameters'."""
    n = world_size()
    (loss if n == 1 else loss / n).backward()


def all_reduce_grads(grads: Iterable[Optional[torch.Tensor]]) -> None:
    """Sum the gradients over the ranks in place, as one flat buffer (one
    collective a step; on NCCL it is captured with the step's CUDA graph)."""
    if world_size() == 1:
        return
    grads = [g for g in grads if g is not None]
    if grads:
        _all_reduce_flat(grads)


@torch.no_grad()
def _all_reduce_flat(grads) -> None:
    """``all_reduce_grads``' collective: the tensors summed over the ranks
    in place through one flat buffer."""
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat)
    off = 0
    for g in grads:
        n = g.numel()
        g.copy_(flat[off:off + n].view(g.shape))
        off += n


class _GlobalBatchNorm(torch.autograd.Function):
    """Training-mode BatchNorm on the global batch's statistics, in f32.

    Forward: each rank's pixel count, per-channel mean and centred sum of
    squares (two-pass over its rows), gathered in one buffer and combined
    in rank order (Chan et al.'s pairwise update): the global mean and
    biased variance without the cancellation of a raw sum of squares,
    which a channel whose mean dwarfs its spread (a 1x1 pool over a few
    samples) would suffer. Backward: the sums of ``dy`` and of
    ``dy * xhat`` all-reduced in one buffer; the parameters' gradients are
    this rank's share (the optimizer sums them)."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps):
        c = x.shape[1]
        xf = x.float()
        n_r = x.numel() // c
        mean_r = xf.mean((0, 2, 3))
        d = xf - mean_r.view(1, -1, 1, 1)
        stats = torch.cat([mean_r, (d * d).sum((0, 2, 3)),
                           torch.full((1,), n_r, dtype=torch.float32,
                                      device=x.device)])
        every = _all_gather(stats[None])                  # (N, 2C + 1)
        counts = every[:, 2 * c:]                         # (N, 1)
        n = counts.sum()
        mean = (counts * every[:, :c]).sum(0) / n
        m2 = (every[:, c:2 * c]
              + counts * (every[:, :c] - mean) ** 2).sum(0)
        var = m2 / n
        rstd = torch.rsqrt(var + eps)
        y = (xf - mean.view(1, -1, 1, 1)) * (rstd * weight).view(1, -1, 1, 1) \
            + bias.view(1, -1, 1, 1)
        ctx.save_for_backward(x, mean, rstd, weight, n)
        ctx.mark_non_differentiable(mean, var)
        return y.to(x.dtype), mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, mean, rstd, weight, n = ctx.saved_tensors
        c = x.shape[1]
        dy = dy.float()
        xhat = (x.float() - mean.view(1, -1, 1, 1)) * rstd.view(1, -1, 1, 1)
        sdy = dy.sum((0, 2, 3))
        sdyx = (dy * xhat).sum((0, 2, 3))
        buf = torch.cat([sdy, sdyx])
        dist.all_reduce(buf)
        dx = (weight * rstd).view(1, -1, 1, 1) * (
            dy - (buf[:c] / n).view(1, -1, 1, 1)
            - xhat * (buf[c:] / n).view(1, -1, 1, 1))
        return dx.to(x.dtype), sdyx, sdy, None


def batch_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float):
    """(y in ``x``'s dtype, global batch mean, global biased variance) of a
    training-mode BatchNorm over every rank's rows; ``weight`` and ``bias``
    f32. For world size > 1 (``models/resnet.py``'s ``BatchNorm`` keeps its
    own path at 1)."""
    return _GlobalBatchNorm.apply(x, weight, bias, eps)
