"""Host-side dataset IO: file pairing and decoding.

The port's copy of the eval part of ``uemda_tpu/datasets/io.py`` (reference
``uemda/datasets/basedata.py:28-119``): images are ``*.png``/``*.tif`` under
``image_dir``; hard masks pair by identical filename under ``mask_dir``.
PIL is imported inside the readers only, so hosts without it (the GPU
machine) can import the package and use in-memory datasets.
"""

import glob as _glob
import os
from typing import Dict, List

import numpy as np


def list_images(image_dir) -> List[str]:
    dirs = image_dir if isinstance(image_dir, (list, tuple)) else [image_dir]
    paths: List[str] = []
    for d in dirs:
        if d is None:
            continue
        paths += _glob.glob(os.path.join(d, "*.tif"))
        paths += _glob.glob(os.path.join(d, "*.png"))
    paths.sort()
    return paths


def mask_path_for(image_path: str, mask_dir: str) -> str:
    return os.path.join(mask_dir, os.path.basename(image_path))


def read_image(path: str) -> np.ndarray:
    """(H, W, 3) uint8/uint16 image."""
    from PIL import Image

    with Image.open(path) as im:
        arr = np.asarray(im)
    if arr.ndim == 2:
        arr = np.stack([arr] * 3, axis=-1)
    return arr[..., :3]


def read_mask(path: str, offset: int, num_classes: int, ignore_label: int = -1):
    """Hard id mask: raw + offset, ids >= C clamped to ignore
    (basedata.py:84-89)."""
    from PIL import Image

    with Image.open(path) as im:
        arr = np.asarray(im).astype(np.int32)
    arr = arr + offset
    arr[arr >= num_classes] = ignore_label
    return arr


class RamCache:
    """Decode-once tile cache."""

    def __init__(self):
        self._store: Dict[str, np.ndarray] = {}

    def get(self, path: str, reader) -> np.ndarray:
        hit = self._store.get(path)
        if hit is None:
            hit = reader(path)
            self._store[path] = hit
        return hit
