"""Dataset objects (host side).

The port's copy of ``uemda_tpu/datasets/base.py``: a split of images with
hard masks read from disk (:class:`SegDataset`), an in-memory split of
arrays (:class:`ArrayDataset`), the shuffled training stream
(:func:`infinite_batches`) and the eval-order batch iterator
(SequentialSampler, reference ``daLoader.py``). The host only reads and
stacks raw uint8 tiles; augmentation runs on the device.
"""

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np

from uemda_tpu_torch.datasets.io import (
    RamCache,
    list_images,
    mask_path_for,
    read_image,
    read_mask,
)
from uemda_tpu_torch.datasets.meta import DatasetMeta


@dataclasses.dataclass
class SegDataset:
    """A split on disk: images and, when ``mask_dir`` is set, hard masks."""

    meta: DatasetMeta
    image_dir: object  # str or list[str]
    mask_dir: Optional[str] = None
    cache: Optional[RamCache] = None

    def __post_init__(self):
        self.image_paths = list_images(self.image_dir)
        if not self.image_paths:
            raise FileNotFoundError(f"no images under {self.image_dir}")
        if self.cache is None:
            self.cache = RamCache()

    def __len__(self):
        return len(self.image_paths)

    def item(self, idx: int) -> Dict[str, np.ndarray]:
        path = self.image_paths[idx]
        out = {"image": self.cache.get(path, read_image)}
        if self.mask_dir:
            meta = self.meta
            out["label"] = self.cache.get(
                mask_path_for(path, self.mask_dir),
                lambda p: read_mask(p, meta.offset, meta.num_classes,
                                    meta.ignore_label))
        return out

    def batch(self, indices) -> Dict[str, np.ndarray]:
        items = [self.item(int(i)) for i in indices]
        return {k: np.stack([it[k] for it in items]) for k in items[0]}


@dataclasses.dataclass
class ArrayDataset:
    """An in-memory split: uint8 images (N, H, W, 3), int32 labels (N, H, W)."""

    meta: DatasetMeta
    images: np.ndarray
    labels: np.ndarray

    def __len__(self):
        return len(self.images)

    def batch(self, indices) -> Dict[str, np.ndarray]:
        idx = np.asarray(indices, np.int64)
        return {"image": self.images[idx], "label": self.labels[idx]}


def infinite_batches(dataset, batch_size: int, seed: int = 0,
                     skip_batches: int = 0) -> Iterator[Dict[str, np.ndarray]]:
    """Shuffled epoch-cycling batch iterator (DALoader semantics:
    RandomSampler + drop_last=True, ``daLoader.py:38-55``), the numpy
    stream of ``uemda_tpu/datasets/base.py:118-177`` without its multi-host
    ``process_shard`` and ``host_crop``: the same seed and skip give the
    same batch indices as the JAX package. ``skip_batches`` fast-forwards
    the shuffle stream without reading any tile."""
    rng = np.random.default_rng(seed)
    n = len(dataset)
    skipped = 0
    while True:
        perm = rng.permutation(n)
        stop = (n // batch_size) * batch_size
        for i in range(0, max(stop, batch_size), batch_size):
            if skipped < skip_batches:
                skipped += 1
                continue
            idx = perm[i:i + batch_size]
            if len(idx) < batch_size:
                idx = np.concatenate([idx, perm[:batch_size - len(idx)]])
            yield dataset.batch(idx)


def sequential_batches(dataset, batch_size: int = 1):
    """Eval-order iterator of ``(indices, batch)``."""
    for i in range(0, len(dataset), batch_size):
        idx = list(range(i, min(i + batch_size, len(dataset))))
        yield idx, dataset.batch(idx)
