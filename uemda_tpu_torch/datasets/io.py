"""Host-side dataset IO: file pairing and decoding.

The port's copy of ``uemda_tpu/datasets/io.py`` (reference
``uemda/datasets/basedata.py:28-119``): images are ``*.png``/``*.tif`` under
``image_dir``; hard masks pair by identical filename under ``mask_dir``;
superpixel maps (uint16 ``.tif``) live next to the masks in the
``_sup_shrink`` directory (``basedata.py:62-64``); stage 3's soft pseudo
labels are ``<filename>.npy`` files of (H, W, C) fp16, or the reference's
``.pt`` (C, H, W) tensors.
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


def sup_path_for(image_path: str) -> str:
    """Superpixel map path by directory substitution (basedata.py:62-64):
    ``img_dir`` -> ``ann_dir`` (``images_png`` -> ``masks_png``) +
    ``_sup_shrink``, the image's stem + ``.tif``."""
    d, fname = os.path.split(image_path)
    sup_dir = d.replace("img_dir", "ann_dir").replace("images_png",
                                                      "masks_png")
    return os.path.join(sup_dir + "_sup_shrink", fname.split(".")[0] + ".tif")


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


def read_sup(path: str) -> np.ndarray:
    """(H, W) int32 superpixel id map (a uint16 tif)."""
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im).astype(np.int32)


def read_prob(path_base: str) -> np.ndarray:
    """(H, W, C) soft label from ``<path_base>.npy`` (HWC) or the reference's
    ``<path_base>.pt`` (CHW, ``basedata.py:87``). The values stay in the
    file's float type on the host -- fp16 for the ``.npy`` files -- and are
    cast to f32 on the device (exact: every fp16 value is an f32 value),
    which halves host memory and the upload against the JAX package's
    host-side f32 cast."""
    if os.path.exists(path_base + ".npy"):
        arr = np.load(path_base + ".npy")
    elif os.path.exists(path_base + ".pt"):
        import torch

        t = torch.load(path_base + ".pt", map_location="cpu")
        arr = t.numpy().transpose(1, 2, 0)
    else:
        raise FileNotFoundError(path_base + ".{npy,pt}")
    if arr.dtype not in (np.float16, np.float32):
        arr = arr.astype(np.float32)
    return np.ascontiguousarray(arr)


def save_prob(path_base: str, prob_hwc: np.ndarray) -> None:
    """Write ``<path_base>.npy`` as (H, W, C) fp16."""
    np.save(path_base + ".npy", np.asarray(prob_hwc).astype(np.float16))


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
