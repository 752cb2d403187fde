"""Affine-free instance norm: the K1 CUDA kernel and its plain version.

Port of ``uemda_tpu/ops/pallas_insnorm.py:instance_norm_1read``, the drop-in
for ``uemda_tpu/models/deeplabv2.py:instance_norm`` (torch
``nn.InstanceNorm2d`` defaults, reference ``Encoder.py:118-123``):
per (sample, channel) over H x W, eps 1e-5, two-pass f32 statistics,
output rounded once to the input dtype. The kernel is
``uemda_tpu_torch/kernels/csrc/insnorm.cu``.
"""

import torch

from uemda_tpu_torch import kernels


def instance_norm_plain(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """The ``deeplabv2.py:26-43`` formula: mean, then the mean of squared
    deviations (never E[x^2]-E[x]^2), in f32."""
    xf = x.float()
    mean = xf.mean(dim=(2, 3), keepdim=True)
    var = (xf - mean).square().mean(dim=(2, 3), keepdim=True)
    y = ((xf - mean) * torch.rsqrt(var + eps)).to(x.dtype)
    return y.contiguous(memory_format=torch.channels_last)


def instance_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """(B, C, H, W) channels_last -> same. A CPU tensor takes the plain
    version; a CUDA tensor launches the kernel (C a multiple of 32)."""
    if x.device.type == "cpu":
        return instance_norm_plain(x, eps)
    kernels.check_cuda_input(x, "instance_norm x")
    b, c, h, w = x.shape
    if c % 32:
        raise ValueError(f"instance_norm kernel needs C % 32 == 0, got C={c}")
    y = torch.empty_like(x, memory_format=torch.channels_last)
    fn = kernels.function("insnorm", "uemda_instance_norm",
                          [kernels.P, kernels.P, kernels.I, kernels.I,
                           kernels.I, kernels.I, kernels.F, kernels.P])
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), y.data_ptr(), b, h * w, c,
                 int(x.dtype == torch.bfloat16), eps, kernels.stream_of(x))
    kernels.check_launch("insnorm", "uemda_instance_norm", err)
    instance_norm.launches += 1
    return y


instance_norm.launches = 0
