"""Dataset objects (host side).

The port's copy of ``uemda_tpu/datasets/base.py``: a split of images with
hard masks or stage 3's soft pseudo labels read from disk
(:class:`SegDataset`), an in-memory split of arrays (:class:`ArrayDataset`),
the shuffled training stream, whole tiles or cropped on the host
(:func:`infinite_batches`) and the eval-order batch iterator
(SequentialSampler, reference ``daLoader.py``). The host only reads and
stacks raw uint8 tiles; augmentation runs on the device.
"""

import dataclasses
import os
from typing import Dict, Iterator, Optional

import numpy as np

from uemda_tpu_torch.datasets.io import (
    RamCache,
    list_images,
    mask_path_for,
    read_image,
    read_mask,
    read_prob,
    read_sup,
    sup_path_for,
)
from uemda_tpu_torch.datasets.meta import DatasetMeta


@dataclasses.dataclass
class SegDataset:
    """A split on disk: images; with ``mask_dir``, hard masks
    (``label_type="id"``) or the soft labels the pseudo-label sweep wrote
    there (``"prob"``: ``prob``, (H, W, C) fp16); superpixel maps (``sup``)
    with ``read_sup``."""

    meta: DatasetMeta
    image_dir: object  # str or list[str]
    mask_dir: Optional[str] = None
    cache: Optional[RamCache] = None
    read_sup: bool = False
    label_type: str = "id"  # 'id' | 'prob' | 'none'

    def __post_init__(self):
        if self.label_type not in ("id", "prob", "none"):
            raise ValueError(f"unknown label_type {self.label_type!r}")
        self.image_paths = list_images(self.image_dir)
        if not self.image_paths:
            raise FileNotFoundError(f"no images under {self.image_dir}")
        if self.cache is None:
            self.cache = RamCache()

    def __len__(self):
        return len(self.image_paths)

    def filename(self, idx: int) -> str:
        return os.path.basename(self.image_paths[idx])

    def item(self, idx: int) -> Dict[str, np.ndarray]:
        path = self.image_paths[idx]
        out = {"image": self.cache.get(path, read_image)}
        if self.mask_dir and self.label_type == "id":
            meta = self.meta
            out["label"] = self.cache.get(
                mask_path_for(path, self.mask_dir),
                lambda p: read_mask(p, meta.offset, meta.num_classes,
                                    meta.ignore_label))
        elif self.mask_dir and self.label_type == "prob":
            out["prob"] = self.cache.get(mask_path_for(path, self.mask_dir),
                                         read_prob)
        if self.read_sup:
            out["sup"] = self.cache.get(sup_path_for(path), read_sup)
        return out

    def batch(self, indices) -> Dict[str, np.ndarray]:
        items = [self.item(int(i)) for i in indices]
        return {k: np.stack([it[k] for it in items]) for k in items[0]}


@dataclasses.dataclass
class ArrayDataset:
    """An in-memory split: uint8 images (N, H, W, 3) and, optionally, int32
    labels (N, H, W), int32 superpixel maps (N, H, W) and stage 3's soft
    labels (N, H, W, C). Sample i is named ``tile_<i>.png``, as
    ``make_synthetic_dataset`` names its files."""

    meta: DatasetMeta
    images: np.ndarray
    labels: Optional[np.ndarray] = None
    sup: Optional[np.ndarray] = None
    prob: Optional[np.ndarray] = None

    def __len__(self):
        return len(self.images)

    def filename(self, idx: int) -> str:
        return f"tile_{idx:03d}.png"

    def item(self, idx: int) -> Dict[str, np.ndarray]:
        """Sample ``idx``'s arrays as views (no copy)."""
        out = {"image": self.images[idx]}
        for key, arr in (("label", self.labels), ("sup", self.sup),
                         ("prob", self.prob)):
            if arr is not None:
                out[key] = arr[idx]
        return out

    def batch(self, indices) -> Dict[str, np.ndarray]:
        idx = np.asarray(indices, np.int64)
        out = {"image": self.images[idx]}
        for key, arr in (("label", self.labels), ("sup", self.sup),
                         ("prob", self.prob)):
            if arr is not None:
                out[key] = arr[idx]
        return out


def _host_crop_batch(dataset, indices, u, crop_hw) -> Dict[str, np.ndarray]:
    """A batch with each sample's spatial arrays cropped on the host to
    ``crop_hw``, at origins mapped from the uniforms ``u`` (B, 2)
    (``uemda_tpu/datasets/base.py:89-115``). Each window is a numpy view of
    the sample (``item`` gives views of the RAM cache or of the in-memory
    split); ``np.stack`` makes the only copy. A sample smaller than the crop
    raises with its file named."""
    ch, cw = crop_hw
    items = []
    for j, i in enumerate(indices):
        it = dataset.item(int(i))
        h, w = it["image"].shape[:2]
        if h < ch or w < cw:
            raise ValueError(
                f"--host-crop: sample {dataset.filename(int(i))} is {h}x{w}, "
                f"smaller than the crop {ch}x{cw}; tiles must be >= the crop "
                "(the device crop has the same precondition)")
        # floor(u * (range + 1)), clamped: the uniform-origin law of the
        # device crop's randint(0, range + 1)
        top = min(int(u[j, 0] * (h - ch + 1)), h - ch)
        left = min(int(u[j, 1] * (w - cw + 1)), w - cw)
        items.append({k: v[top:top + ch, left:left + cw]
                      for k, v in it.items()})
    return {k: np.stack([it[k] for it in items]) for k in items[0]}


def infinite_batches(dataset, batch_size: int, seed: int = 0,
                     skip_batches: int = 0, process_shard=None,
                     host_crop=None) -> Iterator[Dict[str, np.ndarray]]:
    """Shuffled epoch-cycling batch iterator (DALoader semantics:
    RandomSampler + drop_last=True, ``daLoader.py:38-55``), the numpy
    stream of ``uemda_tpu/datasets/base.py:118-177``: the same seed and
    skip give the same batches as the JAX package. ``skip_batches``
    fast-forwards the shuffle stream without reading any tile.

    ``process_shard=(start, size)``: data parallelism -- every rank draws
    the same global shuffle stream but reads only rows [start, start +
    size) of each global batch of ``batch_size`` (``parallel/multihost.py:
    local_batch_slice``), so the ranks' batches concatenate to one rank's.

    ``host_crop=(ch, cw)`` crops every sample on the host before it ships
    (:func:`_host_crop_batch`): 4x fewer bytes to upload for 1024^2 tiles
    cropped to 512^2. The origins are drawn per (seed, batch index) from
    ``default_rng((seed, 9157, batch index))``, the index counting skipped
    batches too, so a skip replays the same crops. The device crop then
    takes the whole (crop-sized) tile; flips and rot90 stay on the
    device. The origins are drawn for the global batch before
    ``process_shard`` takes this rank's rows."""
    rng = np.random.default_rng(seed)
    n = len(dataset)
    skipped = 0
    b_index = 0
    while True:
        perm = rng.permutation(n)
        stop = (n // batch_size) * batch_size
        for i in range(0, max(stop, batch_size), batch_size):
            this_b, b_index = b_index, b_index + 1
            if skipped < skip_batches:
                skipped += 1
                continue
            idx = perm[i:i + batch_size]
            if len(idx) < batch_size:
                idx = np.concatenate([idx, perm[:batch_size - len(idx)]])
            u = (np.random.default_rng((seed, 9157, this_b)).random(
                (len(idx), 2)) if host_crop is not None else None)
            if process_shard is not None:
                start, size = process_shard
                idx = idx[start:start + size]
                if u is not None:
                    u = u[start:start + size]
            if u is None:
                yield dataset.batch(idx)
            else:
                yield _host_crop_batch(dataset, idx, u, host_crop)


def sequential_batches(dataset, batch_size: int = 1,
                       decode_workers: int = 1):
    """Eval-order iterator of ``(indices, batch)`` (``uemda_tpu/datasets/
    base.py:180-204``). ``decode_workers > 1`` decodes the items of each
    batch on a thread pool: PNG/TIFF decompression releases the GIL, so on
    a multi-core serving host the decode stops serializing the pipeline."""
    ex = None
    if decode_workers > 1:
        from concurrent.futures import ThreadPoolExecutor

        ex = ThreadPoolExecutor(decode_workers)
    try:
        for i in range(0, len(dataset), batch_size):
            idx = list(range(i, min(i + batch_size, len(dataset))))
            if ex is None:
                yield idx, dataset.batch(idx)
            else:
                items = list(ex.map(lambda j: dataset.item(int(j)), idx))
                yield idx, {k: np.stack([it[k] for it in items])
                            for k in items[0]}
    finally:
        if ex is not None:
            ex.shutdown(wait=False)


def kfold_indices(n: int, k: int = 10, fold: int = 0, seed: int = 2333):
    """Deterministic k-fold split ``(train_idx, val_idx)``
    (``uemda_tpu/datasets/base.py:208-219``; ever's
    CrossValSamplerGenerator behind DALoader's CV config, which every
    shipped config disables with fold -1): a ``default_rng(seed)``
    permutation of ``range(n)`` cut into ``k`` folds, ``fold % k`` held
    out. ``fold < 0``: every index trains, none validates."""
    if fold < 0:
        return np.arange(n), np.arange(0)
    perm = np.random.default_rng(seed).permutation(n)
    folds = np.array_split(perm, k)
    val = folds[fold % k]
    train = np.concatenate([f for j, f in enumerate(folds) if j != fold % k])
    return train, val
