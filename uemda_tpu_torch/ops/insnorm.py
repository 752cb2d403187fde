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
again, and sees bit for bit the forward's x-hat.
"""

from typing import Tuple

import torch

from uemda_tpu_torch import kernels


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


def _check_channels(x: torch.Tensor, name: str) -> None:
    kernels.check_cuda_input(x, name)
    if x.shape[1] % 32:
        raise ValueError(f"{name}: the kernel needs C % 32 == 0, got "
                         f"C={x.shape[1]}")


def instance_norm_forward(x: torch.Tensor, eps: float = 1e-5):
    """(B, C, H, W) channels_last -> (y, mean, rstd) with (B, C) f32
    statistics. A CPU tensor takes the plain version; a CUDA tensor launches
    the K1 forward kernel (C a multiple of 32)."""
    if x.device.type == "cpu":
        return instance_norm_forward_plain(x, eps)
    _check_channels(x, "instance_norm x")
    b, c, h, w = x.shape
    y = torch.empty_like(x, memory_format=torch.channels_last)
    mean = torch.empty((b, c), dtype=torch.float32, device=x.device)
    rstd = torch.empty_like(mean)
    fn = kernels.function("insnorm", "uemda_instance_norm",
                          [kernels.P, kernels.P, kernels.P, kernels.P,
                           kernels.I, kernels.I, kernels.I, kernels.I,
                           kernels.F, kernels.P])
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), y.data_ptr(), mean.data_ptr(),
                 rstd.data_ptr(), b, h * w, c,
                 int(x.dtype == torch.bfloat16), eps, kernels.stream_of(x))
    kernels.check_launch("insnorm", "uemda_instance_norm", err)
    instance_norm.launches += 1
    return y, mean, rstd


def instance_norm_backward(x: torch.Tensor, dy: torch.Tensor,
                           mean: torch.Tensor, rstd: torch.Tensor
                           ) -> torch.Tensor:
    """dx for (B, C, H, W) channels_last x and dy of one dtype and the
    forward's (B, C) f32 mean and rstd. A CPU tensor takes the plain
    version; a CUDA tensor launches the K1 backward kernel."""
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
    dx = torch.empty_like(x, memory_format=torch.channels_last)
    fn = kernels.function("insnorm", "uemda_instance_norm_backward",
                          [kernels.P, kernels.P, kernels.P, kernels.P,
                           kernels.P, kernels.I, kernels.I, kernels.I,
                           kernels.I, kernels.P])
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), dy.data_ptr(), mean.data_ptr(),
                 rstd.data_ptr(), dx.data_ptr(), b, h * w, c,
                 int(x.dtype == torch.bfloat16), kernels.stream_of(x))
    kernels.check_launch("insnorm", "uemda_instance_norm_backward", err)
    instance_norm_backward.launches += 1
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
