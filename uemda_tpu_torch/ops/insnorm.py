"""Affine-free instance norm and its gradient: the K1 CUDA kernels and their
plain versions.

Port of ``uemda_tpu/ops/pallas_insnorm.py:instance_norm_1read``, the drop-in
for ``uemda_tpu/models/deeplabv2.py:instance_norm`` (torch
``nn.InstanceNorm2d`` defaults, reference ``Encoder.py:118-123``):
per (sample, channel) over H x W, eps 1e-5, two-pass f32 statistics,
output rounded once to the input dtype. The Pallas kernel is forward-only;
training goes through this op, so the port adds a backward kernel computing
the cotangent ``jax.grad`` of ``deeplabv2.py:26-43`` gives. Both kernels are
``uemda_tpu_torch/kernels/csrc/insnorm.cu``.

:func:`instance_norm` is a ``torch.autograd.Function`` when its input needs
a gradient. The forward kernel also writes the f32 mean and rstd of every
(sample, channel) -- 8 bytes per channel -- and the backward kernel reads
them, so the backward reads x and dy once each, computes no statistic of x
again, and sees bit for bit the forward's x-hat. Each launch runs a plan
(:func:`instance_norm_forward_plan`, :func:`instance_norm_backward_plan`,
pure Python, tested on the CPU): a thread block cluster splits each
(sample, channel chunk) slab's H x W; the launcher checks the plan. Each
default plan and its int array are built once per shape, dtype and card.
"""

import ctypes
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from uemda_tpu_torch import kernels
from uemda_tpu_torch.ops.resblock import SMEM_LIMIT


def _stat_dtype(x: torch.Tensor) -> torch.dtype:
    """f32 statistics for f32/bf16 inputs; f64 inputs (gradcheck) stay f64."""
    return torch.promote_types(x.dtype, torch.float32)


def instance_norm_forward_plain(x: torch.Tensor, eps: float = 1e-5
                                ) -> Tuple[torch.Tensor, torch.Tensor,
                                           torch.Tensor]:
    """The ``deeplabv2.py:26-43`` formula: mean, then the mean of squared
    deviations (never E[x^2]-E[x]^2), in f32. Returns (y, mean, rstd) with
    (B, C) statistics."""
    xf = x.to(_stat_dtype(x))
    mean = xf.mean(dim=(2, 3), keepdim=True)
    var = (xf - mean).square().mean(dim=(2, 3), keepdim=True)
    rstd = torch.rsqrt(var + eps)
    y = ((xf - mean) * rstd).to(x.dtype)
    return (y.contiguous(memory_format=torch.channels_last),
            mean[:, :, 0, 0].contiguous(), rstd[:, :, 0, 0].contiguous())


def instance_norm_plain(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    return instance_norm_forward_plain(x, eps)[0]


def instance_norm_backward_plain(x: torch.Tensor, dy: torch.Tensor,
                                 mean: torch.Tensor, rstd: torch.Tensor
                                 ) -> torch.Tensor:
    """The kernel's arithmetic written out (not autograd of the forward):
    ``dx = rstd * (dy - mean(dy) - xhat * mean(dy * xhat))`` with f32
    statistics over H x W, dx rounded once to x's dtype."""
    sd = _stat_dtype(x)
    mu = mean.to(sd)[:, :, None, None]
    rs = rstd.to(sd)[:, :, None, None]
    xh = (x.to(sd) - mu) * rs
    d = dy.to(sd)
    m1 = d.mean(dim=(2, 3), keepdim=True)
    m2 = (d * xh).mean(dim=(2, 3), keepdim=True)
    dx = (rs * (d - m1 - xh * m2)).to(x.dtype)
    return dx.contiguous(memory_format=torch.channels_last)


# bytes a CTA aims to stage (x for the forward, x and dy for the
# backward): the fastest part size in chip_smoke.py's design sweeps of the
# backward at the flagship shape in both dtypes, and of the forward at the
# serving batch of 32 and in f32 (in bf16 at batch 8, 128 KB was ~4% faster)
PART_BYTES = 64 * 1024
MAX_CLUSTER = 8   # the portable cluster size


def fwd_static_smem(cb: int) -> int:
    """Static shared memory of the forward kernel at chunk width ``cb``: the
    warps' partial sums (8 x cb f32), the CTA's sums and the slab's
    statistics (2 x cb f32 each)."""
    return (8 + 2 + 2) * cb * 4


def bwd_static_smem(cb: int) -> int:
    """Static shared memory of the backward kernel at chunk width ``cb``:
    the warps' partial sums (8 x 2 x cb f32), the CTA's sums and the slab's
    means (2 x cb f32 each)."""
    return (8 * 2 + 2 + 2) * cb * 4


@dataclass(frozen=True)
class InstanceNormPlan:
    """One launch of a K1 kernel: ``cb`` channels a CTA; ``cluster`` CTAs
    (a thread block cluster) split a slab's H x W, ``ppc`` = ceil(H*W /
    cluster) pixels each, the last holding the rest; ``smem`` dynamic
    shared-memory bytes (the CTA's part of the inputs on the "smem" route,
    0 on the "global" one, which reads the inputs again for each pass);
    ``grid`` (cluster * C / cb, B)."""
    route: str
    cb: int
    cluster: int
    ppc: int
    smem: int
    grid: Tuple[int, int]

    def as_ints(self):
        """cb, cluster, ppc, smem, route (1 smem, 0 global), grid x, y: the
        int array the C launchers take."""
        return [self.cb, self.cluster, self.ppc, self.smem,
                int(self.route == "smem"), *self.grid]


def _cluster_plan(name, inputs, part_bytes, static_smem, b, c, h, w, dtype,
                  cb, cluster, n_sm) -> InstanceNormPlan:
    """Chunks of 64 channels where C allows, else 32; the cluster is the
    smallest power of two (at most 8) that brings a CTA's part of the
    ``inputs`` staged tensors within ``part_bytes``, doubled while the grid
    has fewer CTAs than the card has SMs and a CTA keeps 64 pixels or
    more. A part over the shared memory at 64 channels takes 32; over it at
    32 too, the global route. ``cb`` and ``cluster`` pin those choices."""
    if dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{name}: dtype {dtype}")
    if c % 32:
        raise ValueError(f"{name}: C % 32 != 0 ({c})")
    esz = 2 if dtype == torch.bfloat16 else 4
    hw = h * w
    widths = [cb] if cb else [64, 32] if c % 64 == 0 else [32]
    for k in widths:
        if k not in (32, 64) or c % k:
            raise ValueError(f"{name}: cb {k} for C {c}")
    if cluster is None:
        part = inputs * widths[0] * esz  # bytes staged a pixel
        cluster = 1
        while cluster < MAX_CLUSTER and -(-hw // cluster) * part > part_bytes:
            cluster *= 2
        while (cluster < MAX_CLUSTER and b * c // widths[0] * cluster < n_sm
               and -(-hw // (2 * cluster)) >= 64):
            cluster *= 2
    if not 1 <= cluster <= MAX_CLUSTER:
        raise ValueError(f"{name}: cluster {cluster}")
    ppc = -(-hw // cluster)
    for k in widths:
        smem = inputs * ppc * k * esz
        if smem + static_smem(k) <= SMEM_LIMIT:
            return InstanceNormPlan("smem", k, cluster, ppc, smem,
                                    (cluster * c // k, b))
    k = widths[0]
    return InstanceNormPlan("global", k, cluster, ppc, 0,
                            (cluster * c // k, b))


def instance_norm_forward_plan(b: int, c: int, h: int, w: int,
                               dtype: torch.dtype, cb: Optional[int] = None,
                               cluster: Optional[int] = None,
                               n_sm: int = kernels.N_SM) -> InstanceNormPlan:
    """The launch plan of the K1 forward for (b, c, h, w) in ``dtype``: a
    CTA stages its part of x, aiming at PART_BYTES (the rule of
    :func:`_cluster_plan`)."""
    return _cluster_plan("instance_norm_forward_plan", 1, PART_BYTES,
                         fwd_static_smem, b, c, h, w, dtype, cb, cluster,
                         n_sm)


def instance_norm_backward_plan(b: int, c: int, h: int, w: int,
                                dtype: torch.dtype, cb: Optional[int] = None,
                                cluster: Optional[int] = None,
                                n_sm: int = kernels.N_SM) -> InstanceNormPlan:
    """The launch plan of the K1 backward for (b, c, h, w) in ``dtype``: a
    CTA stages its part of x and dy, aiming at PART_BYTES (the rule of
    :func:`_cluster_plan`)."""
    return _cluster_plan("instance_norm_backward_plan", 2, PART_BYTES,
                         bwd_static_smem, b, c, h, w, dtype, cb, cluster,
                         n_sm)


def _check_channels(x: torch.Tensor, name: str) -> None:
    kernels.check_cuda_input(x, name)
    if x.shape[1] % 32:
        raise ValueError(f"{name}: the kernel needs C % 32 == 0, got "
                         f"C={x.shape[1]}")


def _check_aligned(name: str, *tensors) -> None:
    for t, what in tensors:
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {what} is not 16-byte aligned (the "
                             "kernel moves 16 bytes at a time)")


def _plan_and_ints(which, plan_fn, x, plan):
    """``plan`` or, if None, ``plan_fn``'s default for x (made once per
    shape, dtype and card), with its ctypes int array."""
    if plan is not None:
        return plan, kernels.plan_ints(plan)
    b, c, h, w = x.shape
    return kernels.cached_plan(
        (which, b, c, h, w, x.dtype, x.device.index),
        lambda: plan_fn(b, c, h, w, x.dtype, n_sm=kernels.sm_count(x.device)))


def instance_norm_forward(x: torch.Tensor, eps: float = 1e-5, *,
                          plan: Optional[InstanceNormPlan] = None):
    """(B, C, H, W) channels_last -> (y, mean, rstd) with (B, C) f32
    statistics. A CPU tensor takes the plain version; a CUDA tensor launches
    the K1 forward kernel (C a multiple of 32) on ``plan`` (default:
    :func:`instance_norm_forward_plan`'s), kept in
    ``instance_norm_forward.plan``."""
    if x.device.type == "cpu":
        return instance_norm_forward_plain(x, eps)
    _check_channels(x, "instance_norm x")
    _check_aligned("instance_norm", (x, "x"))
    b, c, h, w = x.shape
    plan, arr = _plan_and_ints("fwd", instance_norm_forward_plan, x, plan)
    y = torch.empty_like(x, memory_format=torch.channels_last)
    # mean and rstd in one allocation: each (B, C) half starts 128-byte
    # aligned (C % 32 == 0)
    mean, rstd = torch.empty((2, b, c), dtype=torch.float32,
                             device=x.device).unbind(0)
    fn = kernels.function("insnorm", "uemda_instance_norm",
                          [kernels.P] * 4 + [kernels.I] * 4
                          + [kernels.F, kernels.P, kernels.I, kernels.P])
    with kernels.on_device(x):
        err = fn(x.data_ptr(), y.data_ptr(), mean.data_ptr(),
                 rstd.data_ptr(), b, h * w, c,
                 int(x.dtype == torch.bfloat16), eps, ctypes.addressof(arr),
                 len(arr), kernels.stream_of(x))
    kernels.check_launch("insnorm", "uemda_instance_norm", err)
    instance_norm.launches += 1
    instance_norm_forward.plan = plan
    return y, mean, rstd


def instance_norm_backward(x: torch.Tensor, dy: torch.Tensor,
                           mean: torch.Tensor, rstd: torch.Tensor, *,
                           plan: Optional[InstanceNormPlan] = None
                           ) -> torch.Tensor:
    """dx for (B, C, H, W) channels_last x and dy of one dtype and the
    forward's (B, C) f32 mean and rstd. A CPU tensor takes the plain
    version; a CUDA tensor launches the K1 backward kernel on ``plan``
    (default: :func:`instance_norm_backward_plan`'s), kept in
    ``instance_norm_backward.plan``."""
    if x.device.type == "cpu":
        return instance_norm_backward_plain(x, dy, mean, rstd)
    _check_channels(x, "instance_norm_backward x")
    kernels.check_cuda_input(dy, "instance_norm_backward dy")
    if dy.shape != x.shape or dy.dtype != x.dtype:
        raise ValueError(f"instance_norm_backward: dy {tuple(dy.shape)} "
                         f"{dy.dtype} does not match x {tuple(x.shape)} "
                         f"{x.dtype}")
    b, c, h, w = x.shape
    for t, name in ((mean, "mean"), (rstd, "rstd")):
        kernels.check_cuda_input(t, f"instance_norm_backward {name}", ndim=2,
                                 dtypes=(torch.float32,), channels_last=False)
        if tuple(t.shape) != (b, c):
            raise ValueError(f"instance_norm_backward: {name} "
                             f"{tuple(t.shape)} is not ({b}, {c})")
    _check_aligned("instance_norm_backward", (x, "x"), (dy, "dy"),
                   (mean, "mean"), (rstd, "rstd"))
    plan, arr = _plan_and_ints("bwd", instance_norm_backward_plan, x, plan)
    dx = torch.empty_like(x, memory_format=torch.channels_last)
    fn = kernels.function("insnorm", "uemda_instance_norm_backward",
                          [kernels.P] * 5 + [kernels.I] * 4
                          + [kernels.P, kernels.I, kernels.P])
    with kernels.on_device(x):
        err = fn(x.data_ptr(), dy.data_ptr(), mean.data_ptr(),
                 rstd.data_ptr(), dx.data_ptr(), b, h * w, c,
                 int(x.dtype == torch.bfloat16), ctypes.addressof(arr),
                 len(arr), kernels.stream_of(x))
    kernels.check_launch("insnorm", "uemda_instance_norm_backward", err)
    instance_norm_backward.launches += 1
    instance_norm_backward.plan = plan
    return dx


class _InstanceNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, eps):
        y, mean, rstd = instance_norm_forward(x, eps)
        ctx.save_for_backward(x, mean, rstd)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, mean, rstd = ctx.saved_tensors
        dy = dy.to(x.dtype).contiguous(memory_format=torch.channels_last)
        return instance_norm_backward(x, dy, mean, rstd), None


def instance_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """(B, C, H, W) channels_last -> same, differentiable. A CPU tensor takes
    the plain versions; a CUDA tensor launches the K1 kernels (C a multiple
    of 32)."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _InstanceNorm.apply(x, eps)
    return instance_norm_forward(x, eps)[0]


instance_norm.launches = 0
instance_norm_backward.launches = 0
instance_norm_forward.plan = None   # the InstanceNormPlan of the last launch
instance_norm_backward.plan = None  # the InstanceNormPlan of the last launch
