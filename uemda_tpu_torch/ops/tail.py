"""Eval tail: the K3 CUDA kernel and its plain version.

Port of ``uemda_tpu/ops/pallas_tail.py:tail_upsample_softmax_mean``:
bilinear upsample (align_corners=True) of the stacked head logits, f32
softmax per head, mean over the heads (reference ``Encoder.py:152-155``).
Softmax runs on unrounded f32 and the output is rounded once
(``pallas_tail.py:21-24``). The kernel is
``uemda_tpu_torch/kernels/csrc/tail.cu``.
"""

import torch
import torch.nn.functional as F

from uemda_tpu_torch import kernels

MAX_CLASSES = 16  # kMaxNC in tail.cu


def tail_upsample_softmax_mean_plain(cat: torch.Tensor, out_hw, g: int,
                                     nc: int) -> torch.Tensor:
    up = F.interpolate(cat.float(), size=tuple(int(s) for s in out_hw),
                       mode="bilinear", align_corners=True)
    probs = sum(torch.softmax(up[:, i * nc:(i + 1) * nc], dim=1)
                for i in range(g)) / g
    return probs.to(cat.dtype).contiguous(memory_format=torch.channels_last)


def tail_upsample_softmax_mean(cat: torch.Tensor, out_hw, g: int,
                               nc: int) -> torch.Tensor:
    """``cat`` (B, g*nc, Hi, Wi) channels_last -> (B, nc, Ho, Wo)
    channels_last averaged per-head softmax in ``cat.dtype``. A CPU tensor
    takes the plain version; a CUDA tensor launches the kernel."""
    b, gc, hi, wi = cat.shape
    if gc != g * nc:
        raise ValueError(f"cat has {gc} channels, expected g*nc={g * nc}")
    if cat.device.type == "cpu":
        return tail_upsample_softmax_mean_plain(cat, out_hw, g, nc)
    kernels.check_cuda_input(cat, "tail cat")
    if nc > MAX_CLASSES:
        raise ValueError(f"tail kernel takes at most {MAX_CLASSES} classes")
    ho, wo = int(out_hw[0]), int(out_hw[1])
    out = torch.empty((b, nc, ho, wo), dtype=cat.dtype, device=cat.device,
                      memory_format=torch.channels_last)
    sh = (hi - 1) / (ho - 1) if ho > 1 else 0.0
    sw = (wi - 1) / (wo - 1) if wo > 1 else 0.0
    fn = kernels.function("tail", "uemda_tail",
                          [kernels.P, kernels.P] + [kernels.I] * 7
                          + [kernels.F, kernels.F, kernels.I, kernels.P])
    with torch.cuda.device(cat.device):
        err = fn(cat.data_ptr(), out.data_ptr(), b, hi, wi, ho, wo, g, nc,
                 sh, sw, int(cat.dtype == torch.bfloat16),
                 kernels.stream_of(cat))
    kernels.check_launch("tail", "uemda_tail", err)
    tail_upsample_softmax_mean.launches += 1
    return out


tail_upsample_softmax_mean.launches = 0
