"""The card: what the run may use, what it reports, what it must not load."""

import subprocess
import sys
from typing import Dict, List, Optional

# top-level module names that must never be loaded by a measured process:
# JAX and its libraries, and the JAX package the port was made from. The
# names are compared whole: "uemda_tpu_torch" is the port, not "uemda_tpu".
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "ml_dtypes", "uemda_tpu")

HBM_BYTES_PER_S = 3.35e12     # H100 SXM data sheet
PEAK_BF16_FLOPS = 989e12      # dense bf16 tensor-core rate, data sheet


def forbidden_loaded(modules=None) -> List[str]:
    """The forbidden top-level names among ``modules`` (``sys.modules``)."""
    modules = sys.modules if modules is None else modules
    tops = {name.split(".")[0] for name in list(modules)}
    return sorted(t for t in tops if t in FORBIDDEN)


def require_cards(n: int) -> None:
    """Raise unless PyTorch sees at least ``n`` CUDA devices."""
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the benchmark measures the card "
                           "and never falls back to the CPU")
    if torch.cuda.device_count() < n:
        raise RuntimeError(f"the cell asks for {n} cards, "
                           f"{torch.cuda.device_count()} are visible")


def init_cards(n: int) -> None:
    """Create the CUDA context on each of the first ``n`` cards."""
    import torch

    for i in range(n):
        torch.empty(1, device=f"cuda:{i}")
    torch.cuda.synchronize()


def smi() -> Optional[Dict[str, str]]:
    """The card's clock, power draw, power limit and temperature from
    ``nvidia-smi``, or None where it cannot be read."""
    q = "name,clocks.sm,power.draw,power.limit,temperature.gpu"
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--query-gpu={q}", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    vals = [v.strip() for v in out.splitlines()[0].split(",")]
    return dict(zip(q.split(","), vals))


def device_record(count: int = 1) -> dict:
    import torch

    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": count,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated())}
