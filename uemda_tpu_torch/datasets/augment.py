"""Eval-time input transform: the port's copy of ``normalize`` from
``uemda_tpu/datasets/augment.py`` (the configs' EVAL pipelines normalize
only)."""

import torch


def normalize(image: torch.Tensor, mean, std, clamp: bool = False) -> torch.Tensor:
    """(B, 3, H, W) image (any dtype) -> (x - mean) / std in f32."""
    mean = torch.as_tensor(mean, dtype=torch.float32, device=image.device)
    std = torch.as_tensor(std, dtype=torch.float32, device=image.device)
    out = (image.float() - mean.view(1, -1, 1, 1)) / std.view(1, -1, 1, 1)
    if clamp:
        out = torch.clamp(out, max=1.0)
    return out
