"""Fused stem conv + 3x3/s2 max-pool: the K2 CUDA kernel and its plain
version.

Port of ``uemda_tpu/ops/pallas_stem.py:stem_pool_pallas``. The BN-folded
stem, re-indexed for the 2x2 space-to-depth input by
``infer/fastpath._s2d_stem_kernel``, runs as a 4x4/s1 conv with padding
(2, 1) per axis, then bias and ReLU, then the torch-style 3x3/s2 max-pool;
only the pooled map is written. The wrapper takes the space-to-depth input
and the (4, 4, 12, 64) folded weight as they are: the TPU's ``pack_cw`` and
``pack_stem_weight`` existed only for its (8, 128) tiling and have no
counterpart here. The kernel is ``uemda_tpu_torch/kernels/csrc/stem.cu``.
"""

import torch
import torch.nn.functional as F

from uemda_tpu_torch import kernels


def stem_pool_plain(x: torch.Tensor, w: torch.Tensor,
                    b: torch.Tensor) -> torch.Tensor:
    """``tests/test_pallas_stem.py:18-27``: conv with pad (2, 1), output
    rounded to the dtype, bias added in the dtype, ReLU, max_pool2d(3, 2, 1).
    x (B, 12, H2, W2); w (4, 4, 12, 64) HWIO; b (64,)."""
    wt = w.to(x.dtype).permute(3, 2, 0, 1)  # HWIO -> OIHW
    y = F.conv2d(F.pad(x, (2, 1, 2, 1)), wt)
    y = torch.relu(y + b.to(x.dtype).view(1, -1, 1, 1))
    y = F.max_pool2d(y, 3, 2, 1)
    return y.contiguous(memory_format=torch.channels_last)


def stem_pool(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor
              ) -> torch.Tensor:
    """x (B, 12, H2, W2) channels_last; w (4, 4, 12, 64) contiguous in x's
    dtype; b (64,) f32. Returns relu(conv) max-pooled, (B, 64, ceil(H2/2),
    ceil(W2/2)) channels_last. A CPU tensor takes the plain version; a CUDA
    tensor launches the kernel."""
    if x.device.type == "cpu":
        return stem_pool_plain(x, w, b)
    kernels.check_cuda_input(x, "stem_pool x")
    kernels.check_cuda_input(w, "stem_pool w", dtypes=(x.dtype,),
                             channels_last=False)
    kernels.check_cuda_input(b, "stem_pool b", ndim=1,
                             dtypes=(torch.float32,), channels_last=False)
    bsz, c, h2, w2 = x.shape
    if c != 12 or tuple(w.shape) != (4, 4, 12, 64) or tuple(b.shape) != (64,):
        raise ValueError(f"stem_pool takes x (B, 12, H2, W2), w (4, 4, 12, 64)"
                         f", b (64,); got {tuple(x.shape)}, {tuple(w.shape)}, "
                         f"{tuple(b.shape)}")
    out = torch.empty((bsz, 64, (h2 + 1) // 2, (w2 + 1) // 2), dtype=x.dtype,
                      device=x.device, memory_format=torch.channels_last)
    fn = kernels.function("stem", "uemda_stem_pool",
                          [kernels.P] * 4 + [kernels.I] * 4 + [kernels.P])
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(),
                 bsz, h2, w2, int(x.dtype == torch.bfloat16),
                 kernels.stream_of(x))
    kernels.check_launch("stem", "uemda_stem_pool", err)
    stem_pool.launches += 1
    return out


stem_pool.launches = 0
