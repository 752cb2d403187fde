"""Dataset evaluation: batched slide inference + on-device confusion matrix.

Port of ``uemda_tpu/infer/evaluate.py:evaluate_dataset`` (reference
``uemda/utils/eval.py:14-56``): images go through the slide(+TTA)
predictor in batches, the (C, C) confusion matrix accumulates on the
device, and only the final matrix crosses to the host. IsprsDA drops class 0
from the means (``eval.py:16-17``).
"""

from typing import Tuple

import numpy as np
import torch

from uemda_tpu_torch.datasets.augment import normalize
from uemda_tpu_torch.datasets.base import sequential_batches
from uemda_tpu_torch.infer.slide import make_predictor
from uemda_tpu_torch.ops.metrics import PixelMetricSummary, confusion_matrix
from uemda_tpu_torch.utils.runtime import resolve_device


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
):
    """``model``: a callable (N, 3, th, tw) -> (N, C, th, tw) probabilities
    (the eval-mode ``DeeplabV2`` or a ``FastpathModel``) on ``device``.
    ``dataset``: anything with ``meta``, ``__len__`` and ``batch(indices)``
    giving uint8 (B, H, W, 3) images and int32 (B, H, W) labels. Returns
    ``(summary, miou)``."""
    device = resolve_device(device)
    meta = dataset.meta
    hw = None
    predictor = None
    cm = torch.zeros((meta.num_classes, meta.num_classes), dtype=torch.int64,
                     device=device)
    for _, batch in sequential_batches(dataset, batch_size):
        # uint8 crosses to the device; normalize casts to f32 there
        images = torch.from_numpy(np.ascontiguousarray(batch["image"])).to(device)
        images = images.permute(0, 3, 1, 2)
        if predictor is None or tuple(images.shape[2:]) != hw:
            hw = tuple(images.shape[2:])
            predictor = make_predictor(model, tile, hw, tta=tta,
                                       compute_dtype=compute_dtype)
        probs = predictor(normalize(images, mean, std))
        pred = probs.argmax(dim=1)
        label = torch.from_numpy(np.asarray(batch["label"])).to(device)
        cm += confusion_matrix(label, pred, meta.num_classes)

    pm = PixelMetricSummary(meta.num_classes, class_names=meta.class_names,
                            ignore_labels=list(meta.eval_ignore_labels))
    summary = pm.summarize(cm)
    if logger is not None:
        logger.info("\n" + pm.format_table(summary))
    return summary, summary["miou"]
