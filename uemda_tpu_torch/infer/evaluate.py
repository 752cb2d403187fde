"""Dataset evaluation: batched slide inference + on-device confusion matrix.

Port of ``uemda_tpu/infer/evaluate.py`` (reference ``uemda/utils/eval.py:
14-56``): images stream through :func:`device_batches` (decode and upload
on worker threads, the last batch padded) into the slide(+TTA) predictor,
on the card one captured CUDA graph; the (C, C) confusion matrix
accumulates on the device, and only the final matrix crosses to the host.
IsprsDA drops class 0 from the means (``eval.py:16-17``). Under data
parallelism the eval CLI shards the split over the ranks and sums their
confusion matrices (``data_parallel``).
"""

from typing import Optional, Tuple

import numpy as np
import torch

from uemda_tpu_torch.datasets.augment import normalize
from uemda_tpu_torch.datasets.base import sequential_batches
from uemda_tpu_torch.datasets.prefetch import (
    HostReadback,
    prefetch,
    upload_batches,
)
from uemda_tpu_torch.infer.slide import make_predictor
from uemda_tpu_torch.ops.metrics import PixelMetricSummary, confusion_matrix
from uemda_tpu_torch.parallel import mesh
from uemda_tpu_torch.utils.runtime import resolve_device
from uemda_tpu_torch.utils.viz import VisualizeSegmm


def collect_calib_batches(dataset, batch_size, mean, std, n,
                          tile: Optional[Tuple[int, int]] = None, device=None):
    """The first ``n`` normalized batches, (B, 3, th, tw) f32 on ``device``,
    for int8 activation-scale calibration
    (``infer.fastpath.calibrate_act_scales``), cropped to ``tile`` with even
    sides: serving runs tile-sized forwards through the slide predictor, so
    calibration sees the same shapes. Reads the plain sequential reader."""
    if n <= 0:
        return []
    device = resolve_device(device)
    out = []
    for _, batch in sequential_batches(dataset, batch_size):
        images = np.asarray(batch["image"])  # uint8; normalize casts on device
        if tile is not None:
            th = min(tile[0], images.shape[1]) // 2 * 2
            tw = min(tile[1], images.shape[2]) // 2 * 2
            images = images[:, :th, :tw]
        img = torch.from_numpy(np.ascontiguousarray(images)).to(device)
        out.append(normalize(img.permute(0, 3, 1, 2), mean, std))
        if len(out) >= n:
            break
    return out


class RankShare:
    """Rank ``r`` of ``n``'s share of an evaluation split: images r, r + n,
    r + 2n, ... under the dataset's interface (``meta``, ``__len__``,
    ``filename``, ``item``, ``batch``)."""

    def __init__(self, dataset, r: int, n: int):
        self.dataset, self.ids = dataset, list(range(r, len(dataset), n))
        self.meta = dataset.meta

    def __len__(self) -> int:
        return len(self.ids)

    def filename(self, i: int) -> str:
        return self.dataset.filename(self.ids[i])

    def item(self, i: int):
        return self.dataset.item(self.ids[i])

    def batch(self, indices):
        return self.dataset.batch([self.ids[int(i)] for i in indices])


def device_batches(dataset, batch_size: int, depth: int = 2,
                   decode_workers: int = 1, device=None,
                   with_label: bool = False):
    """Stream ``(indices, images, n_valid, label)`` with the decode, the
    batch padding and the host-to-device copy on worker threads, so the
    next batch's transfer overlaps the current batch's compute (the twin of
    ``uemda_tpu/infer/evaluate.py:23-61``; under data parallelism a rank
    streams its share, :class:`RankShare`). ``images``: uint8 (B, 3, H, W) on
    ``device`` (channels_last; normalization casts on the device, so the
    copy ships 4x fewer bytes than f32), the last batch padded with zero
    images to ``batch_size`` so that one captured predictor serves the whole
    split. ``label``: the batch's (n_valid, H, W) labels, on ``device`` with
    ``with_label`` (evaluation), else the host array (or None) as JAX
    yields it. The decode runs on its own thread (``decode_workers`` a
    batch: ``sequential_batches``), the upload on the upload stage's
    (``datasets/prefetch.py``: own stream, reused pinned buffers)."""
    device = resolve_device(device)

    def host_batches():
        for indices, batch in sequential_batches(
                dataset, batch_size, decode_workers=decode_workers):
            images = np.asarray(batch["image"])
            n = images.shape[0]
            if n < batch_size:
                images = np.concatenate([images, np.zeros(
                    (batch_size - n,) + images.shape[1:], images.dtype)])
            yield {"indices": indices, "n": n, "image": images,
                   "label": batch.get("label")}

    keys = ("image", "label") if with_label else ("image",)
    staged = upload_batches(prefetch(host_batches(), depth), device, depth,
                            keys=keys)
    try:
        for b in staged:
            yield (b["indices"], b["image"].permute(0, 3, 1, 2), b["n"],
                   b["label"])
    finally:
        staged.close()  # stops both workers


def predict_batches(model, dataset, mean, std, tile: Tuple[int, int],
                    tta: bool, batch_size: int, compute_dtype: torch.dtype,
                    device, decode_workers: int = 1,
                    with_label: bool = False, capture: bool = True,
                    epilogue=None):
    """The serving loop the evaluation, the sweep and ``infer_dir`` share:
    ``dataset`` through :func:`device_batches` and normalization into one
    slide(+TTA) predictor per image size (``infer/slide.make_predictor``:
    on the card a captured CUDA graph unless ``capture=False``; the
    sweep's ``epilogue`` inside it), released when the loop ends. Yields
    ``(indices, n_valid, label, output)``, the output the predictor's for
    the padded batch (its static buffers on the card: read, or enqueue
    reads of, them before the next batch)."""
    # mean and std on the device once: a per-batch host tensor would be a
    # synchronous copy
    mean = torch.as_tensor(mean, dtype=torch.float32, device=device)
    std = torch.as_tensor(std, dtype=torch.float32, device=device)
    predictor, hw = None, None
    try:
        for indices, images, n, label in device_batches(
                dataset, batch_size, decode_workers=decode_workers,
                device=device, with_label=with_label):
            if predictor is None or tuple(images.shape[2:]) != hw:
                if predictor is not None:
                    predictor.close()
                hw = tuple(images.shape[2:])
                predictor = make_predictor(model, tile, hw, tta=tta,
                                           compute_dtype=compute_dtype,
                                           capture=capture, epilogue=epilogue)
            yield indices, n, label, predictor(normalize(images, mean, std))
    finally:
        if predictor is not None:
            predictor.close()


def evaluate_dataset(
    model,
    dataset,
    mean,
    std,
    tile: Tuple[int, int] = (512, 512),
    tta: bool = False,
    batch_size: int = 8,
    compute_dtype: torch.dtype = torch.bfloat16,
    device=None,
    logger=None,
    vis_dir: Optional[str] = None,
    decode_workers: int = 1,
    capture: bool = True,
    data_parallel: bool = False,
):
    """``model``: a callable (N, 3, th, tw) -> (N, C, th, tw) probabilities
    (the eval-mode ``DeeplabV2`` or a ``FastpathModel``) on ``device``.
    ``dataset``: anything with ``meta``, ``__len__`` and ``batch(indices)``
    giving uint8 (B, H, W, 3) images and int32 (B, H, W) labels. Batches
    come through :func:`predict_batches` (padded to ``batch_size``; on the
    card the predictor is one captured CUDA graph, ``capture=False``: eager
    calls), released when the evaluation ends. The confusion matrix
    accumulates on the device behind the replays; only the final matrix
    crosses to the host. ``vis_dir``: palette PNGs of each image's argmax
    (``uemda_tpu/infer/evaluate.py:121,140-144``), read back one batch
    late through pinned buffers. Returns ``(summary, miou)``; the summary
    also holds the (C, C) ``confusion_matrix`` as nested lists.

    ``data_parallel`` (the eval CLI's ``--num-devices``/``--multihost``):
    each rank evaluates its share of the split (:class:`RankShare`) and
    the confusion matrices are summed over the ranks, so every rank
    returns what one rank evaluating the whole split would."""
    device = resolve_device(device)
    meta = dataset.meta
    if data_parallel and mesh.world_size() > 1:
        dataset = RankShare(dataset, mesh.rank(), mesh.world_size())
    viz = VisualizeSegmm(vis_dir, meta.palette) if vis_dir else None
    readback = HostReadback()

    def write(item):
        if item is None:
            return
        indices, arrays = item
        for j, idx in enumerate(indices):
            viz(arrays["pred"][j], dataset.filename(idx).replace("tif", "png"))

    cm = torch.zeros((meta.num_classes, meta.num_classes), dtype=torch.int64,
                     device=device)
    for indices, n, label, probs in predict_batches(
            model, dataset, mean, std, tile, tta, batch_size, compute_dtype,
            device, decode_workers, with_label=True, capture=capture):
        pred = probs[:n].argmax(dim=1)
        cm += confusion_matrix(label, pred, meta.num_classes)
        if viz is not None:
            write(readback.push(indices, {"pred": pred.to(torch.uint8)}))
    if viz is not None:
        write(readback.flush())
    if data_parallel:
        cm = mesh.gsum(cm)

    pm = PixelMetricSummary(meta.num_classes, class_names=meta.class_names,
                            ignore_labels=list(meta.eval_ignore_labels))
    summary = pm.summarize(cm)
    summary["confusion_matrix"] = cm.cpu().tolist()
    if logger is not None:
        logger.info("\n" + pm.format_table(summary))
    return summary, summary["miou"]
