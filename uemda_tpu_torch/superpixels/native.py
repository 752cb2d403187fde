"""ctypes binding of the repo's C++ superpixel runtime
(``native/superpixels.cpp``): LSC, SLIC and the boundary shrink.

The port's own copy of ``uemda_tpu/superpixels/native.py`` (reference
``uemda/gast/superpixels.py:49-152``, OpenCV's LSC and a Python shrink
loop), with the same functions, signatures and defaults. This runs on the
host: superpixel maps are made offline, before training, and read from
disk by the stage-2 and stage-3 datasets (``datasets/io.py: sup_path_for,
read_sup``).

At first use the source is compiled with ``g++ -O3 -shared -fPIC`` into
``build/torch_ext/`` at the root of the checkout, named by a hash of the
source and flags; the compiler writes a pid-unique temporary file, which
is renamed into place, so processes that build at once never load a half
written library (pid and thread in the temporary name). Nothing is
written beside the source. A failed build
raises. The C functions run without the GIL (ctypes releases it), so
tiles can be processed on a thread pool.
"""

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Tuple

import numpy as np

ROOT = Path(__file__).resolve().parents[2]
SOURCE = ROOT / "native" / "superpixels.cpp"
BUILD_DIR = ROOT / "build" / "torch_ext"
CXX_FLAGS = ("-O3", "-shared", "-fPIC")

_lock = threading.Lock()
_lib = None


def lib_path() -> Path:
    """The library's path under ``build/torch_ext/`` for this source and
    these flags."""
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libsuperpixels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the source if its library is missing; returns the path.
    Raises with the compiler's output on failure."""
    out = lib_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    p = subprocess.run(["g++", *CXX_FLAGS, str(SOURCE), "-o", str(tmp)],
                       capture_output=True, text=True)
    if p.returncode:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed for {SOURCE}:\n{p.stdout}{p.stderr}")
    os.replace(tmp, out)
    return out


def _load():
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build()))
        for fn_name in ("slic_superpixels", "lsc_superpixels"):
            fn = getattr(lib, fn_name)
            fn.restype = ctypes.c_int
            fn.argtypes = [
                ctypes.POINTER(ctypes.c_uint8),
                ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_float, ctypes.c_int,
                ctypes.POINTER(ctypes.c_int32),
            ]
        lib.edge_shrink.restype = None
        lib.edge_shrink.argtypes = [
            ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32),
        ]
        _lib = lib
        return lib


def slic_superpixels(
    image: np.ndarray,
    region_size: int = 16,
    ratio: float = 0.075,
    iterations: int = 100,
    algo: str = "lsc",
) -> Tuple[int, np.ndarray]:
    """(H, W, 3) uint8 RGB -> (n_superpixels, (H, W) int32 label map).
    ``algo='lsc'`` (the reference's algorithm) runs kernelized linear
    spectral clustering, ``'slic'`` plain SLIC; the defaults are the
    reference's LSC call (``superpixels.py:106``)."""
    lib = _load()
    img = np.ascontiguousarray(image[..., :3], dtype=np.uint8)
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"slic_superpixels: an (H, W, 3) image, not "
                         f"{np.shape(image)}")
    h, w = img.shape[:2]
    labels = np.empty((h, w), np.int32)
    fn = lib.lsc_superpixels if algo == "lsc" else lib.slic_superpixels
    n = fn(
        img.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        h, w, region_size, ctypes.c_float(ratio), iterations,
        labels.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    return int(n), labels


def edge_shrink(
    labels: np.ndarray, win_size: int = 3, boundary_id: int = None
) -> np.ndarray:
    """Mark every pixel with a differing label inside its (2w+1)^2 window as
    ``boundary_id`` (the reference's default: (h/16)*(w/16),
    ``superpixels.py:129-133``)."""
    lib = _load()
    lab = np.ascontiguousarray(labels, dtype=np.int32)
    if lab.ndim != 2:
        raise ValueError(f"edge_shrink: an (H, W) label map, not {lab.shape}")
    h, w = lab.shape
    if boundary_id is None:
        boundary_id = (h // 16) * (w // 16)
    out = np.empty_like(lab)
    lib.edge_shrink(
        lab.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        h, w, win_size, boundary_id,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    return out


def superpixels_with_shrink(
    image: np.ndarray,
    region_size: int = 16,
    ratio: float = 0.075,
    iterations: int = 100,
    win_size: int = 3,
    algo: str = "lsc",
) -> Tuple[int, np.ndarray, np.ndarray]:
    """The offline product: (n, labels, the shrunk labels with boundary id
    (h/rs)*(w/rs)), the map the 's' refinement view reads."""
    n, labels = slic_superpixels(image, region_size, ratio, iterations, algo)
    h, w = labels.shape
    boundary = (h // region_size) * (w // region_size)
    shrunk = edge_shrink(labels, win_size, boundary)
    return n, labels, shrunk
