"""Per-sample window crop + per-channel normalize: the K9 CUDA kernel and its
plain version.

Port of ``uemda_tpu/ops/pallas_kernels.py:crop_normalize_pallas``: from
(B, H, W, 3) raw images (uint8 as the loader ships them, or f32) and (B, 2)
int32 (y, x) window origins, the (th, tw) window of every sample as
``(x - mean) * (1 / std)`` in f32, with ``1 / std`` taken in f32 as
``pallas_kernels.py:356`` takes it. The result is handed on as the
(B, 3, th, tw) channels_last tensor the model takes (its memory is the
(B, th, tw, 3) tile). The kernel is ``uemda_tpu_torch/kernels/csrc/crop.cu``.
"""

from typing import Sequence, Tuple

import numpy as np
import torch

from uemda_tpu_torch import kernels

MAX_BATCH = 256  # crop.cu kMaxBatch: the origins ride in the parameters


def _stats(mean: Sequence[float], std: Sequence[float]
           ) -> Tuple[np.ndarray, np.ndarray]:
    """f32 mean and f32 reciprocal of std."""
    m = np.asarray(mean, np.float32)
    return m, np.float32(1.0) / np.asarray(std, np.float32)


def check_offsets(offsets, image_hw, crop_hw) -> np.ndarray:
    """(B, 2) integer origins (tensor on any device, or array) -> a
    C-contiguous int32 host array; raises unless every window lies inside
    the image."""
    if isinstance(offsets, torch.Tensor):
        if offsets.is_floating_point():
            raise ValueError(f"crop offsets must be integers, got "
                             f"{offsets.dtype}")
        offsets = offsets.cpu().numpy()
    off = np.ascontiguousarray(offsets, dtype=np.int32)
    if off.ndim != 2 or off.shape[1] != 2:
        raise ValueError(f"crop offsets must be (B, 2), got {off.shape}")
    (h, w), (th, tw) = image_hw, crop_hw
    bad = ((off[:, 0] < 0) | (off[:, 1] < 0) | (off[:, 0] + th > h)
           | (off[:, 1] + tw > w))
    if bad.any():
        i = int(np.flatnonzero(bad)[0])
        raise ValueError(f"crop window {th}x{tw} at (y, x) = "
                         f"{tuple(off[i].tolist())} of sample {i} lies outside "
                         f"the {h}x{w} image")
    return off


def crop_normalize_plain(images: torch.Tensor, offsets: torch.Tensor,
                         crop_hw, mean, std) -> torch.Tensor:
    """Slice each window, cast to f32, subtract the mean, multiply by the
    f32 reciprocal of std; (B, 3, th, tw) channels_last."""
    th, tw = int(crop_hw[0]), int(crop_hw[1])
    off = check_offsets(offsets, images.shape[1:3], (th, tw))
    m, inv = (torch.from_numpy(t).to(images.device) for t in _stats(mean, std))
    tiles = torch.stack([images[i, y:y + th, x:x + tw]
                         for i, (y, x) in enumerate(off.tolist())])
    out = (tiles.float() - m) * inv
    return out.permute(0, 3, 1, 2)


def crop_normalize(images: torch.Tensor, offsets: torch.Tensor, crop_hw,
                   mean, std) -> torch.Tensor:
    """(B, H, W, 3) uint8 or f32 images and (B, 2) integer offsets (on any
    device; checked on the host) -> (B, 3, th, tw) f32 channels_last. A CPU
    tensor takes the plain version; a CUDA tensor launches the kernel, with
    the origins in its launch parameters (no host-to-device copy)."""
    if images.device.type == "cpu":
        return crop_normalize_plain(images, offsets, crop_hw, mean, std)
    kernels.check_cuda_input(images, "crop_normalize images",
                             dtypes=(torch.uint8, torch.float32),
                             channels_last=False)
    b, h, w, ch = images.shape
    if ch != 3:
        raise ValueError(f"crop_normalize: images must be (B, H, W, 3), got "
                         f"{tuple(images.shape)}")
    th, tw = int(crop_hw[0]), int(crop_hw[1])
    if tuple(offsets.shape) != (b, 2):
        raise ValueError(f"crop_normalize: offsets {tuple(offsets.shape)} "
                         f"for {b} images")
    if b > MAX_BATCH:
        raise ValueError(f"crop_normalize: the kernel takes at most "
                         f"{MAX_BATCH} images a launch, got {b}")
    # stays on the host: the launcher copies it into the kernel's parameters
    off = check_offsets(offsets, (h, w), (th, tw))
    out = torch.empty((b, th, tw, 3), dtype=torch.float32,
                      device=images.device)
    m, inv = _stats(mean, std)
    fn = kernels.function("crop", "uemda_crop_normalize",
                          [kernels.P, kernels.P, kernels.P] + [kernels.I] * 6
                          + [kernels.F] * 6 + [kernels.P])
    with torch.cuda.device(images.device):
        err = fn(images.data_ptr(), off.ctypes.data, out.data_ptr(), b, h, w,
                 th, tw, int(images.dtype == torch.uint8), *m.tolist(),
                 *inv.tolist(), kernels.stream_of(images))
    kernels.check_launch("crop", "uemda_crop_normalize", err)
    crop_normalize.launches += 1
    return out.permute(0, 3, 1, 2)


crop_normalize.launches = 0
