"""Fused uncertainty mining of stage 3: the K8 CUDA kernel and its plain
version.

Port of ``uemda_tpu/ops/pallas_kernels.py:uvem_mine_pallas``: from the
(B, C, H, W) soft label, in one pass, the strict-threshold single-class
pseudo label (``ops/pseudo.py:pseudo_selection``), the pixel entropy ``u``
and the UVEM weight ``w`` (``ops/uncertainty.py``), each (B, H, W). The
stage-3 step mines once and hands ``(w, u)`` to both heads' UVEM loss,
where the JAX step takes one selection pass and one entropy + weight pass
per head. Nothing here carries a gradient: ``u`` is a stop-gradient in the
loss and the label is an integer.

The per-(sample, class) threshold max(cutoff_top * class max, cutoff_low) is
computed by the same torch operations for the kernel as for the plain
version (``ops/pseudo.py:class_thresholds``: an f32 multiply, a max, then
a strict ``>`` in the kernel), so the labels stay bit-equal; ``amax``
propagates a NaN probability into its class's threshold, and no pixel then
selects that class. The kernel is ``uemda_tpu_torch/kernels/csrc/mine.cu``;
it reads the probabilities through their strides, so the NCHW planes and
the channels_last memory a rotated soft label arrives in are both read in
place. Probabilities in fp16 or bf16 are cast to f32 first (exact).
"""

from typing import Tuple

import numpy as np
import torch

from uemda_tpu_torch import kernels
from uemda_tpu_torch.ops.pseudo import class_thresholds, pseudo_selection
from uemda_tpu_torch.ops.uncertainty import pixel_entropy, uvem_weight

_ARGS = [kernels.P] * 5 + [kernels.I] * 4 + [kernels.L] * 4 \
    + [kernels.F] * 5 + [kernels.I] * 3 + [kernels.P]


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
              gamma: float = 4.0, ignore_label: int = -1
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(B, C, H, W) probabilities -> (label int32, w f32, u f32), each
    (B, H, W). A CPU tensor takes the plain version; a CUDA tensor launches
    K8, in any memory layout."""
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
    label = torch.empty((b, h, w), dtype=torch.int32, device=probs.device)
    wgt = torch.empty((b, h, w), dtype=torch.float32, device=probs.device)
    u = torch.empty_like(wgt)
    thr = class_thresholds(probs, cutoff_top, cutoff_low).reshape(b, c) \
        .contiguous()
    # the plain version's Python scalars, each rounded once to f32
    f32 = np.float32
    cl = f32(-1.0 / (m * m)) if m > 0 else f32(0.0)
    cr = f32(-1.0 / ((t - m) ** 2)) if m < t else f32(0.0)
    fn = kernels.function("mine", "uemda_uvem_mine", _ARGS)
    with torch.cuda.device(probs.device):
        err = fn(probs.data_ptr(), thr.data_ptr(), label.data_ptr(),
                 wgt.data_ptr(), u.data_ptr(), b, c, h, w, *probs.stride(),
                 float(f32(m)), float(f32(t)), float(cl), float(cr),
                 float(f32(1.0 / gamma)), int(m > 0), int(m < t),
                 ignore_label, kernels.stream_of(probs))
    kernels.check_launch("mine", "uemda_uvem_mine", err)
    uvem_mine.launches += 1
    return label, wgt, u


uvem_mine.launches = 0
