"""Build and load the port's hand-written CUDA kernels.

Every source ``csrc/<name>.cu`` is compiled by its own ``nvcc`` process, all
started together, into a shared library with a plain C interface
(``-gencode arch=compute_90a,code=sm_90a``, Hopper). The libraries are loaded
with ``ctypes``; the wrappers in ``uemda_tpu_torch.ops`` pass data pointers,
sizes and PyTorch's current stream, and raise on the ``cudaError_t`` each
launcher returns. A file with a plain C interface builds in seconds, where
one that includes PyTorch's headers takes minutes, so no source includes
them.

The build runs at first use into ``build/torch_ext/`` at the root of the
checkout, named by a hash of the sources and flags, so a stale library is
never loaded. Nothing here runs at import: the CPU-only test host has no
``nvcc`` and imports every module.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional, Sequence

import torch

CSRC = Path(__file__).with_name("csrc")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_ext"
SOURCES = ("insnorm", "stem", "tail", "crop", "segment", "mine")
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    cands = [shutil.which("nvcc")]
    if CUDA_HOME:
        cands.append(os.path.join(CUDA_HOME, "bin", "nvcc"))
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: the port's CUDA kernels are built "
                       "with the CUDA toolkit at first use")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for f in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def build(names: Sequence[str] = SOURCES) -> Dict[str, str]:
    """Compile every named source whose library is missing, one ``nvcc``
    each, all in parallel. Returns {name: compiler output, with ptxas's
    registers, shared memory and spills per kernel} for the sources built
    by this call; raises with the compiler's output on failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = _lib_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    logs, failed = {}, []
    for name, (p, tmp, out) in procs.items():
        logs[name] = p.communicate()[0]
        if p.returncode == 0:
            os.replace(tmp, out)
        else:
            failed.append(name)
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    return logs


def function(lib: str, fn: str, argtypes: Sequence) -> ctypes._CFuncPtr:
    """The C launcher ``fn`` of ``csrc/<lib>.cu``, building it if needed.
    Every launcher returns its ``cudaError_t`` as an int."""
    with _lock:
        if lib not in _libs:
            path = _lib_path(lib)
            if not path.exists():
                build([lib])
            _libs[lib] = ctypes.CDLL(str(path))
            _libs[lib].uemda_error_string.restype = ctypes.c_char_p
            _libs[lib].uemda_error_string.argtypes = [ctypes.c_int]
        f = getattr(_libs[lib], fn)
    f.argtypes = list(argtypes)
    f.restype = ctypes.c_int
    return f


def check_launch(lib: str, fn: str, err: int) -> None:
    if err:
        msg = _libs[lib].uemda_error_string(err).decode()
        raise RuntimeError(f"{lib}.{fn} launch failed: cudaError {err} ({msg})")


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def check_cuda_input(t: torch.Tensor, name: str, ndim: int = 4,
                     dtypes=(torch.float32, torch.bfloat16),
                     channels_last: Optional[bool] = True) -> None:
    """Raise unless ``t`` is what a kernel takes: on the card, of a
    supported dtype and rank, laid out channels_last (False: contiguous;
    None: any layout, for a kernel that reads through the strides)."""
    if t.device.type != "cuda":
        raise RuntimeError(f"{name}: expected a CUDA or CPU tensor, got "
                           f"{t.device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name}: dtype {t.dtype} not in {dtypes}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got {tuple(t.shape)}")
    if channels_last and not t.is_contiguous(memory_format=torch.channels_last):
        raise ValueError(f"{name}: the kernel needs a channels_last tensor "
                         "(NHWC in memory); call "
                         ".contiguous(memory_format=torch.channels_last)")
    if channels_last is False and not t.is_contiguous():
        raise ValueError(f"{name}: the kernel needs a contiguous tensor")


P = ctypes.c_void_p
I = ctypes.c_int
L = ctypes.c_longlong
F = ctypes.c_float
