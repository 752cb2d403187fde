"""Device selection for the port's entry points.

Entry points run on the card: ``device=None`` means ``"cuda"`` and raises
``RuntimeError`` when CUDA is missing. The CPU runs only when the caller asks
for it (``device="cpu"``), as the tests do -- nothing falls back to it.
"""

import torch


def resolve_device(device=None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: the port runs on the GPU; pass "
            "device='cpu' to run its plain PyTorch versions on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise RuntimeError(f"unsupported device {dev}")
    return dev
