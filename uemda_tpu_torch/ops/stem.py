"""Fused stem conv + 3x3/s2 max-pool: the K2 CUDA kernel and its plain
version.

Port of ``uemda_tpu/ops/pallas_stem.py:stem_pool_pallas``. The BN-folded
stem, re-indexed for the 2x2 space-to-depth input by
``infer/fastpath._s2d_stem_kernel``, runs as a 4x4/s1 conv with padding
(2, 1) per axis, then bias and ReLU, then the torch-style 3x3/s2 max-pool;
only the pooled map is written. The wrapper takes the space-to-depth input
and the (4, 4, 12, 64) folded weight as they are: the TPU's ``pack_cw`` and
``pack_stem_weight`` existed only for its (8, 128) tiling and have no
counterpart here. The kernel is ``uemda_tpu_torch/kernels/csrc/stem.cu``:
bf16 on the tensor cores (mma.sync, an implicit GEMM over the input tile in
shared memory), f32 on the CUDA cores. Each launch runs a plan
(``stem_plan``, pure Python, tested on the CPU); the launcher checks it.
"""

import ctypes
from dataclasses import dataclass
from typing import Tuple

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


# bf16: 16 x 16 pooled pixels a tile, so 33 x 33 conv pixels from a 36 x 36
# input tile; shared memory holds that tile (bf16), the weight as N x K
# (rows of 192 + 8) and the conv tile (rows of 64 + 8), all bf16
BF16_TILE = 16
BF16_SMEM = (36 * 36 * 12 + 64 * 200 + 33 * 33 * 72) * 2
# f32: 8 x 8 pooled pixels, 17 x 17 conv pixels, a 20 x 20 input tile; the
# input tile, the weight and the conv tile in f32
F32_TILE = 8
F32_SMEM = (20 * 20 * 12 + 192 * 64 + 17 * 17 * 64) * 4


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@dataclass(frozen=True)
class StemPlan:
    """One launch of K2: ``design`` "mma" (bf16, tensor cores, a persistent
    grid of ``grid[0]`` blocks walking the tiles) or "fma" (f32, one block a
    tile, grid (column tiles, row tiles, batch)); ``tile`` the pooled pixels
    of a tile; ``smem`` its shared memory."""
    design: str
    tile: Tuple[int, int]
    smem: int
    grid: Tuple[int, int, int]

    def as_ints(self):
        """design (1 mma, 0 fma), tile rows, cols, smem bytes, grid x, y, z:
        the int array the C launcher takes."""
        return [int(self.design == "mma"), *self.tile, self.smem, *self.grid]


def stem_plan(b: int, h2: int, w2: int, dtype: torch.dtype,
              n_sm: int = kernels.N_SM) -> StemPlan:
    """The launch plan of K2 for x (b, 12, h2, w2). The pooled map is
    (ceil(h2 / 2), ceil(w2 / 2)); bf16 runs at most one block a SM, each
    walking tiles blockIdx.x, + grid, ...; f32 one block a tile."""
    h4, w4 = (h2 + 1) // 2, (w2 + 1) // 2
    if dtype == torch.bfloat16:
        t = BF16_TILE
        n = b * _cdiv(h4, t) * _cdiv(w4, t)
        return StemPlan("mma", (t, t), BF16_SMEM, (min(n, n_sm), 1, 1))
    if dtype != torch.float32:
        raise TypeError(f"stem_plan: dtype {dtype}")
    t = F32_TILE
    return StemPlan("fma", (t, t), F32_SMEM, (_cdiv(w4, t), _cdiv(h4, t), b))


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
    plan = stem_plan(bsz, h2, w2, x.dtype, n_sm=kernels.sm_count(x.device))
    ints = plan.as_ints()
    arr = (ctypes.c_int * len(ints))(*ints)
    fn = kernels.function("stem", "uemda_stem_pool",
                          [kernels.P] * 4 + [kernels.I] * 3
                          + [kernels.P, kernels.I, kernels.P])
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(),
                 bsz, h2, w2, ctypes.addressof(arr), len(ints),
                 kernels.stream_of(x))
    kernels.check_launch("stem", "uemda_stem_pool", err)
    stem_pool.launches += 1
    stem_pool.plan = plan
    return out


stem_pool.launches = 0
stem_pool.plan = None  # the StemPlan of the last launch
