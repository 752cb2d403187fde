"""Fused identity bottleneck block: the K4 CUDA kernel and its plain version.

Port of ``uemda_tpu/ops/pallas_resblock.py:bottleneck_identity_pallas``:
``relu(conv3(relu(conv2(relu(conv1(x))))) + x)`` for a ResNet bottleneck
whose block keeps its width (stride 1, no downsample branch, Cin == Cout),
the 3x3 at ``dilation`` with SAME padding, BN folded into the weights. Each
conv's f32 sum is rounded to the activation dtype before the bias, cast to
that dtype, is added; the residual add runs in the dtype -- the rounding of
the fast path's ``_conv`` in the JAX package. The kernel is
``uemda_tpu_torch/kernels/csrc/resblock.cu``; it keeps the block's
intermediates in shared memory and writes only the output. The weights are
the serving params' folded OIHW tensors (channels_last memory), taken as
they are.
"""

import ctypes

import torch
import torch.nn.functional as F

from uemda_tpu_torch import kernels

CL = torch.channels_last


def bottleneck_identity_plain(x: torch.Tensor, w1: torch.Tensor,
                              b1: torch.Tensor, w2: torch.Tensor,
                              b2: torch.Tensor, w3: torch.Tensor,
                              b3: torch.Tensor, dilation: int = 1
                              ) -> torch.Tensor:
    """``tests/test_pallas_resblock.py:13-27``: each conv without its bias,
    the output rounded to x's dtype, the bias cast to the dtype and added,
    then ReLU; the residual add in the dtype."""
    dt = x.dtype

    def conv(h, w, b, pad, d=1):
        y = F.conv2d(h, w.to(dt), None, 1, pad, d)
        return y + b.to(dt).view(1, -1, 1, 1)

    y = torch.relu(conv(x, w1, b1, 0))
    y = torch.relu(conv(y, w2, b2, dilation, dilation))
    y = conv(y, w3, b3, 0)
    return torch.relu(y + x).contiguous(memory_format=CL)


def _check_fusable(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor,
                  w3: torch.Tensor, dilation: int) -> None:
    """Raise ValueError on a block the fused kernel does not compute: what
    ``infer.fastpath._fusable`` refuses (an int8 entry, a middle conv that is
    not 3x3, Cin != Cout), or mismatched shapes."""
    for name, w in (("w1", w1), ("w2", w2), ("w3", w3)):
        if not w.is_floating_point():
            raise ValueError(f"bottleneck_identity {name}: {w.dtype} weights "
                             "(an int8 entry) do not fuse")
    if x.dim() != 4:
        raise ValueError(f"bottleneck_identity x: expected (B, C, H, W), got "
                         f"{tuple(x.shape)}")
    cin, cmid = x.shape[1], w1.shape[0]
    if tuple(w2.shape[2:]) != (3, 3):
        raise ValueError(f"bottleneck_identity: the middle conv must be 3x3, "
                         f"got {tuple(w2.shape)}")
    if (tuple(w1.shape) != (cmid, cin, 1, 1)
            or tuple(w2.shape) != (cmid, cmid, 3, 3)
            or tuple(w3.shape) != (cin, cmid, 1, 1)):
        raise ValueError(
            f"bottleneck_identity takes an identity block (Cin == Cout): x "
            f"{tuple(x.shape)}, w1 {tuple(w1.shape)}, w2 {tuple(w2.shape)}, "
            f"w3 {tuple(w3.shape)}")
    if int(dilation) < 1:
        raise ValueError(f"bottleneck_identity: dilation {dilation} < 1")


def bottleneck_identity(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                        w2: torch.Tensor, b2: torch.Tensor, w3: torch.Tensor,
                        b3: torch.Tensor, dilation: int = 1) -> torch.Tensor:
    """x (B, C, H, W) channels_last, bf16 or f32; w1 (Cm, C, 1, 1), w2 (Cm,
    Cm, 3, 3) and w3 (C, Cm, 1, 1) in x's dtype, channels_last; biases f32.
    Returns the block's output, a new channels_last tensor. A CPU tensor
    takes the plain version; a CUDA tensor launches the kernel (C and Cm
    multiples of 16)."""
    _check_fusable(x, w1, w2, w3, dilation)
    if x.device.type == "cpu":
        return bottleneck_identity_plain(x, w1, b1, w2, b2, w3, b3, dilation)
    kernels.check_cuda_input(x, "bottleneck_identity x")
    for name, w in (("w1", w1), ("w2", w2), ("w3", w3)):
        kernels.check_cuda_input(w, f"bottleneck_identity {name}",
                                 dtypes=(x.dtype,))
    for name, b in (("b1", b1), ("b2", b2), ("b3", b3)):
        kernels.check_cuda_input(b, f"bottleneck_identity {name}", ndim=1,
                                 dtypes=(torch.float32,), channels_last=False)
    bsz, cin, h, w = x.shape
    cmid = w1.shape[0]
    if cin % 16 or cmid % 16:
        raise ValueError(f"bottleneck_identity: the kernel takes C and Cm in "
                         f"multiples of 16, got {cin}, {cmid}")
    if tuple(b1.shape) != (cmid,) or tuple(b2.shape) != (cmid,) \
            or tuple(b3.shape) != (cin,):
        raise ValueError(f"bottleneck_identity biases {tuple(b1.shape)}, "
                         f"{tuple(b2.shape)}, {tuple(b3.shape)} for C {cin}, "
                         f"Cm {cmid}")
    out = torch.empty_like(x, memory_format=CL)
    ptrs = [t.data_ptr() for t in (x, w1, b1, w2, b2, w3, b3, out)]
    tile = (ctypes.c_int * 2)()
    fn = kernels.function("resblock", "uemda_bottleneck_identity",
                          [kernels.P] * 8 + [kernels.I] * 7 + [kernels.P] * 2)
    with torch.cuda.device(x.device):
        err = fn(*ptrs, bsz, h, w, cin, cmid, int(dilation),
                 int(x.dtype == torch.bfloat16), kernels.stream_of(x),
                 ctypes.addressof(tile))
    kernels.check_launch("resblock", "uemda_bottleneck_identity", err)
    bottleneck_identity.launches += 1
    bottleneck_identity.tile = (tile[0], tile[1])
    return out


bottleneck_identity.launches = 0
bottleneck_identity.tile = None  # the output tile (TH, TW) of the last launch
