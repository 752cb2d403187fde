"""Synthetic datasets for tests and end-to-end checks.

The port's copy of ``uemda_tpu/datasets/synthetic.py``: blocky class regions
with class-dependent colors plus noise; a color shift emulates a domain gap.
Superpixel maps are a regular 16-pixel grid whose cell borders (a two-pixel
ring) carry the max id, as LSC + the edge shrink mark them
(``uemda_tpu/datasets/synthetic.py:95-108``). :func:`synthetic_split`
builds a split in memory (no files, no PIL); :func:`make_synthetic_dataset`
writes the reference's on-disk layout (``img_dir/{train,val}`` +
``ann_dir`` + ``ann_dir/<split>_sup_shrink``).
"""

import os
from typing import Tuple

import numpy as np

from uemda_tpu_torch.datasets.base import ArrayDataset
from uemda_tpu_torch.datasets.meta import DatasetMeta


def _blocky_labels(rng, hw: int, num_classes: int, cell: int = 16) -> np.ndarray:
    g = rng.integers(0, num_classes, size=(hw // cell, hw // cell))
    return np.kron(g, np.ones((cell, cell), np.int64)).astype(np.int32)


def _render(rng, label: np.ndarray, num_classes: int, shift: float = 0.0,
            noise: float = 12.0, palette_mix: float = 0.0):
    """Class-colored image with noise; ``shift`` emulates a domain gap.
    The harder-shift knobs (``uemda_tpu/datasets/synthetic.py:24-47``):
    ``noise`` is the pixel noise's sigma (past the ~29-level palette step
    per-pixel class evidence turns ambiguous while the 16-pixel blocks stay
    recoverable by pooling); ``palette_mix`` rotates each class's color
    that fraction of the way toward the next class's (a systematic
    confusion of adjacent classes)."""
    palette = (
        np.linspace(40, 215, num_classes)[:, None]
        * np.array([[1.0, 0.8, 0.6]])
    )  # (C, 3)
    if palette_mix > 0.0:
        palette = (1.0 - palette_mix) * palette + palette_mix * np.roll(
            palette, -1, axis=0)
    img = palette[label] + rng.normal(0, noise, size=label.shape + (3,))
    img = img + shift
    return np.clip(img, 0, 255).astype(np.uint8)


def grid_superpixels(hw: int, cell: int = 16) -> np.ndarray:
    """(hw, hw) int32 ids of a regular ``cell`` grid; the two pixels on each
    side of an inner cell border carry the max id, (hw/cell)^2."""
    n_sup = (hw // cell) * (hw // cell)
    grid = np.arange(n_sup, dtype=np.int32).reshape(hw // cell, hw // cell)
    sup = np.kron(grid, np.ones((cell, cell), np.int32))
    ring = np.zeros_like(sup, bool)
    for c0 in range(cell, hw, cell):
        ring[c0 - 1:c0 + 1, :] = True
        ring[:, c0 - 1:c0 + 1] = True
    return np.where(ring, n_sup, sup).astype(np.int32)


def synthetic_split(meta: DatasetMeta, n: int, hw: int, seed: int = 0,
                    domain_shift: float = 0.0, with_sup: bool = False
                    ) -> ArrayDataset:
    """``n`` images of ``hw`` x ``hw`` with their labels (and, with
    ``with_sup``, the grid superpixel maps), in memory."""
    rng = np.random.default_rng(seed)
    labels, images = [], []
    for _ in range(n):
        label = _blocky_labels(rng, hw, meta.num_classes)
        images.append(_render(rng, label, meta.num_classes, shift=domain_shift))
        labels.append(label)
    sup = np.broadcast_to(grid_superpixels(hw), (n, hw, hw)) if with_sup \
        else None
    return ArrayDataset(meta, np.stack(images), np.stack(labels), sup)


def make_synthetic_dataset(root: str, meta: DatasetMeta, n_train: int = 8,
                           n_val: int = 2, hw: int = 64, seed: int = 0,
                           domain_shift: float = 0.0, with_sup: bool = True,
                           pad_border: int = 0, noise: float = 12.0,
                           palette_mix: float = 0.0) -> Tuple[str, str]:
    """Write train/val splits as PNGs and, with ``with_sup``, the superpixel
    maps as uint16 ``.tif`` under ``ann_dir/<split>_sup_shrink``; returns
    (img_dir_train, ann_dir_train). ``noise`` and ``palette_mix``: see
    :func:`_render`. ``pad_border``: every other tile (even index) gets a
    black border of that many pixels on its top and left with raw mask 0
    there, LoveDA's padding (raw 0 is ignore under its offset -1)."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    for split, n in (("train", n_train), ("val", n_val)):
        img_dir = os.path.join(root, "img_dir", split)
        ann_dir = os.path.join(root, "ann_dir", split)
        os.makedirs(img_dir, exist_ok=True)
        os.makedirs(ann_dir, exist_ok=True)
        if with_sup:
            os.makedirs(ann_dir + "_sup_shrink", exist_ok=True)
        for i in range(n):
            label = _blocky_labels(rng, hw, meta.num_classes)
            img = _render(rng, label, meta.num_classes, shift=domain_shift,
                          noise=noise, palette_mix=palette_mix)
            raw = (label - meta.offset).astype(np.uint8)
            if pad_border > 0 and i % 2 == 0:
                raw[:pad_border] = img[:pad_border] = 0
                raw[:, :pad_border] = img[:, :pad_border] = 0
            Image.fromarray(img).save(os.path.join(img_dir, f"tile_{i:03d}.png"))
            Image.fromarray(raw).save(os.path.join(ann_dir, f"tile_{i:03d}.png"))
            if with_sup:
                Image.fromarray(grid_superpixels(hw).astype(np.uint16)).save(
                    os.path.join(ann_dir + "_sup_shrink", f"tile_{i:03d}.tif"))
    return (os.path.join(root, "img_dir", "train"),
            os.path.join(root, "ann_dir", "train"))
