"""Device selection for the port's entry points.

Entry points run on the card: ``device=None`` means ``"cuda"`` and raises
``RuntimeError`` when CUDA is missing. The CPU runs only when the caller asks
for it (``device="cpu"``), as the tests do -- nothing falls back to it.
Also the check that f32 matrix products run in full f32, where the JAX
package pins ``Precision.HIGHEST``, and the import of an optional package
that a tool cannot run without.
"""

import importlib

import torch
import torch.distributed as dist


def resolve_device(device=None) -> torch.device:
    """``device`` (None: the card). A rank of a data-parallel group
    (``parallel/``) resolves a bare 'cuda' to its own card, the current
    device its launcher set."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: the port runs on the GPU; pass "
            "device='cpu' to run its plain PyTorch versions on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise RuntimeError(f"unsupported device {dev}")
    if dev.type == "cuda" and dev.index is None and dist.is_available() \
            and dist.is_initialized():
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def require_full_f32(what: str) -> None:
    """Raise unless f32 matmuls run in full f32 (PyTorch's default, TF32 off):
    ``what`` pins ``Precision.HIGHEST`` in the JAX package, and its products
    (and their gradients) would otherwise round through TF32."""
    if torch.get_float32_matmul_precision() != "highest":
        raise RuntimeError(
            f"{what} needs full-f32 matmuls (Precision.HIGHEST in the JAX "
            "package); TF32 is on: torch.get_float32_matmul_precision() is "
            f"{torch.get_float32_matmul_precision()!r}, PyTorch's default is "
            "'highest'")


def require_package(module: str, package: str, what: str):
    """``module`` imported, for ``what``; without it an ``ImportError``
    names the package to install. Nothing is skipped: the tools that draw
    figures or embed features need these packages, and the card's machine
    lacks some of them."""
    try:
        return importlib.import_module(module)
    except ImportError as e:
        raise ImportError(f"{what} needs the {package!r} package "
                          f"(import {module!r} failed: {e})") from e
