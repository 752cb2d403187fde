"""Eval-mode BatchNorm epilogue: BatchNorm on its running statistics, the
residual (as it is, or through its own BatchNorm) and ReLU in one pass --
the CUDA kernel and its plain version.

The standard forward's library chain for a BatchNorm that uses its running
statistics casts the bf16 conv output to f32, normalizes, casts back, then
adds the residual and applies the ReLU as two more passes
(``models/resnet.py: BatchNorm``). This op computes the same thing in f32
from one read of each input: ``y = x * scale + shift``, plus the identity
or ``r * scale_r + shift_r`` (the downsample branch's BatchNorm), then the
ReLU, rounded once to x's dtype, where the chain rounds the BatchNorm's
output and then the sum. ``scale = weight / sqrt(var + eps)`` and ``shift
= bias - mean * scale`` are formed from the BatchNorm's own tensors at every
launch. The kernel is ``uemda_tpu_torch/kernels/csrc/bnact.cu``; the plain
version (CPU tensors) normalizes with the library's f32 BatchNorm, so an
f32 model on the CPU computes what the library chain did, bit for bit.

A BatchNorm is given as ``(running_mean, running_var, weight, bias,
eps)``: C values each, f32 or bf16 (the serving copy of a model is bf16
throughout).
"""

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from uemda_tpu_torch import kernels

Norm = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, float]

THREADS = 256        # bnact.cu: kThreads
BLOCKS_PER_SM = 4    # bnact.cu: kMinBlocks, the resident blocks an SM
_ARGS = [kernels.P] * 3 + [kernels.L] + [kernels.I] * 5 \
    + [kernels.P, kernels.I, kernels.F, kernels.P, kernels.I, kernels.F,
       kernels.I, kernels.P]


def _normalize(t: torch.Tensor, norm: Norm) -> torch.Tensor:
    """The library's f32 BatchNorm of t on the running statistics, as
    :class:`~uemda_tpu_torch.models.resnet.BatchNorm` calls it, unrounded."""
    mean, var, weight, bias, eps = norm
    return F.batch_norm(t.float(), mean.float(), var.float(), weight.float(),
                        bias.float(), False, 0.0, eps)


def bnact_plain(x: torch.Tensor, norm: Norm, relu: bool = True,
                residual: Optional[torch.Tensor] = None,
                residual_norm: Optional[Norm] = None) -> torch.Tensor:
    """The epilogue in plain PyTorch: the library's f32 BatchNorm of x, plus
    the residual in f32 (through its own f32 BatchNorm), ReLU, one rounding
    to x's dtype. In f32 this is the library chain's arithmetic exactly;
    the kernel forms the same affine as one multiply-add a channel."""
    y = _normalize(x, norm)
    if residual is not None:
        y = y + (residual.float() if residual_norm is None
                 else _normalize(residual, residual_norm))
    if relu:
        y = torch.relu(y)
    return y.to(x.dtype)


def launch_grid(n_vectors: int, n_sm: int) -> int:
    """Blocks of a launch: one 16-byte vector (or element) a thread where
    the tensor is small, at most the blocks the card holds at once (each
    then loops over the tensor, ``kUnroll`` vectors in flight)."""
    return max(1, min(-(-n_vectors // THREADS), n_sm * BLOCKS_PER_SM))


def _norm_args(norm: Norm, c: int, device: torch.device, what: str):
    """((mean, var, weight, bias) pointers as a ctypes array, bf16 mask,
    eps) of a BatchNorm, checked: C contiguous f32/bf16 values on x's
    card."""
    tensors, eps = norm[:4], float(norm[4])
    mask = 0
    for i, t in enumerate(tensors):
        if t.device != device or t.dtype not in (torch.float32, torch.bfloat16) \
                or t.dim() != 1 or t.numel() != c or not t.is_contiguous():
            raise ValueError(f"bnact: {what}[{i}] must be {c} contiguous f32 "
                             f"or bf16 values on {device}, got "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}")
        mask |= int(t.dtype == torch.bfloat16) << i
    ptrs = (ctypes.c_void_p * 4)(*[t.data_ptr() for t in tensors])
    return ptrs, mask, eps


def bnact(x: torch.Tensor, norm: Norm, relu: bool = True,
          residual: Optional[torch.Tensor] = None,
          residual_norm: Optional[Norm] = None) -> torch.Tensor:
    """(N, C, H, W) -> same: BatchNorm ``norm`` of x on its running
    statistics, plus ``residual`` (through ``residual_norm`` where given),
    then ReLU if ``relu``; f32 inside, one rounding to x's dtype. A CPU
    tensor takes the plain version; a CUDA tensor (bf16 or f32,
    channels_last, the residual of x's shape and dtype and layout) launches
    the kernel, counted in ``bnact.launches``."""
    if residual_norm is not None and residual is None:
        raise ValueError("bnact: residual_norm without a residual")
    if x.device.type == "cpu":
        return bnact_plain(x, norm, relu, residual, residual_norm)
    kernels.check_cuda_input(x, "bnact x")
    if residual is not None:
        kernels.check_cuda_input(residual, "bnact residual")
        if residual.shape != x.shape or residual.dtype != x.dtype \
                or residual.device != x.device:
            raise ValueError(f"bnact: residual {tuple(residual.shape)} "
                             f"{residual.dtype} does not match x "
                             f"{tuple(x.shape)} {x.dtype}")
    n, c = x.numel(), x.shape[1]
    y = torch.empty_like(x, memory_format=torch.channels_last)
    if n == 0:
        return y
    p, mask, eps = _norm_args(norm, c, x.device, "norm")
    if residual_norm is not None:
        q, mask_r, eps_r = _norm_args(residual_norm, c, x.device,
                                      "residual_norm")
    else:
        q, mask_r, eps_r = p, 0, 0.0
    res_mode = 0 if residual is None else 1 if residual_norm is None else 2
    per_vec = 16 // x.element_size()
    vec = c % per_vec == 0 and all(
        t.data_ptr() % 16 == 0 for t in (x, y, residual) if t is not None)
    grid = launch_grid(n // per_vec if vec else n, kernels.sm_count(x.device))
    fn = kernels.function("bnact", "uemda_bnact", _ARGS)
    with kernels.on_device(x):
        err = fn(x.data_ptr(), 0 if residual is None else residual.data_ptr(),
                 y.data_ptr(), n, c, int(x.dtype == torch.bfloat16), int(vec),
                 res_mode, int(relu), ctypes.addressof(p), mask, eps,
                 ctypes.addressof(q), mask_r, eps_r, grid,
                 kernels.stream_of(x))
    kernels.check_launch("bnact", "uemda_bnact", err)
    bnact.launches += 1
    return y


bnact.launches = 0
