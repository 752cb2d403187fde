"""Pseudo-label generation: the stage-3 sweep over the target split.

The port's copy of ``uemda_tpu/infer/pseudo_gen.py`` (reference
``gener_target_pseudo``, ``uemda/gast/pseudo_generation.py:96-155``): every
target image goes through the batched slide + 8-view TTA predictor
(``infer/slide.py``) in the compute dtype, and its (H, W, C) probabilities
come back as fp16 in host RAM and/or as ``<out_dir>/<filename>.npy`` files,
which ``SegDataset(label_type="prob")`` reads for stage 3. The fp16 cast
happens on the card, so half the bytes cross to the host.

``fastpath=True`` folds the model into the serving fast path
(``infer/fastpath.py:build_fastpath``, exact math, the K2 stem). Where the
JAX package logs and falls back to the standard forward when the fold is
unusable (an odd tile side), the port raises: a sweep never runs another
path than the one asked for. ``color_dir`` writes the mined hard labels
(K8's strict-threshold selection, ``ops/mine.py``) as palette PNGs, as the
reference's ``_color`` directory.

Under data parallelism (``uemda_tpu/infer/pseudo_gen.py:30-61``) process
0 alone runs the sweep, on its own device; the other ranks wait at a
barrier and return an empty dict. The barrier is released in a
``finally``, so a failed sweep raises its own error on process 0 instead
of leaving the others waiting out the group's timeout.
"""

import copy
import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from uemda_tpu_torch.datasets.io import save_prob
from uemda_tpu_torch.datasets.prefetch import HostReadback
from uemda_tpu_torch.infer.evaluate import predict_batches
from uemda_tpu_torch.infer.fastpath import build_fastpath
from uemda_tpu_torch.ops.mine import uvem_mine
from uemda_tpu_torch.parallel.multihost import is_main_process, process_count
from uemda_tpu_torch.utils.runtime import resolve_device


def generate_pseudo_labels(model, dataset, mean, std, **kwargs
                           ) -> Dict[str, np.ndarray]:
    """The sweep (:func:`_generate_pseudo_labels_local`, which documents
    every argument), on process 0 alone under data parallelism: the other
    ranks wait at a barrier until the labels are written (module
    docstring) and return {}."""
    if process_count() == 1:
        return _generate_pseudo_labels_local(model, dataset, mean, std,
                                             **kwargs)
    if not is_main_process():
        dist.barrier()
        return {}
    try:
        return _generate_pseudo_labels_local(model, dataset, mean, std,
                                             **kwargs)
    finally:
        dist.barrier()   # releases the ranks waiting above


@torch.no_grad()
def _generate_pseudo_labels_local(
    model,
    dataset,
    mean,
    std,
    out_dir: Optional[str] = None,
    tile: Tuple[int, int] = (512, 512),
    tta: bool = True,
    batch_size: int = 4,
    cutoff_top: float = 0.8,
    cutoff_low: float = 0.6,
    color_dir: Optional[str] = None,
    keep_in_memory: bool = True,
    compute_dtype: torch.dtype = torch.bfloat16,
    device=None,
    logger=None,
    fastpath: bool = False,
    capture: bool = True,
) -> Dict[str, np.ndarray]:
    """``model``: the trained ``DeeplabV2`` on ``device`` (left as it is:
    the sweep runs an eval-mode copy in ``compute_dtype``, or its folded
    fast path). ``dataset``: anything with ``meta``, ``__len__``,
    ``filename(i)`` and ``batch(indices)`` giving uint8 (B, H, W, 3) images.
    Returns {filename: (H, W, C) fp16} when ``keep_in_memory``, and writes
    ``<out_dir>/<filename>.npy`` when ``out_dir`` is set. Batches come
    through ``predict_batches`` (padded to ``batch_size``); on the card the
    predictor, the fp16 cast and the mining are one captured CUDA graph
    (``capture=False``: eager calls), released when the sweep ends, and
    the results come back through reused pinned buffers one batch late
    (``HostReadback``), so the next replay is never held back."""
    device = resolve_device(device)
    if fastpath:
        if tile[0] % 2 or tile[1] % 2:
            raise ValueError(
                f"pseudo-label fast path: the space-to-depth stem needs even "
                f"tile sides, got {tuple(tile)}; run without the fast path")
        net = build_fastpath(model, dtype=compute_dtype)
    else:
        net = copy.deepcopy(model).eval().to(compute_dtype)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
    viz = None
    if color_dir:
        from uemda_tpu_torch.utils.viz import VisualizeSegmm

        viz = VisualizeSegmm(color_dir, dataset.meta.palette)
    mine = viz is not None
    ignore = dataset.meta.ignore_label

    def epilogue(probs):
        # inside the capture: the fp16 HWC probabilities (half the bytes
        # cross to the host) and, for color_dir, K8's hard labels
        p16 = probs.to(torch.float16).permute(0, 2, 3, 1).contiguous()
        hard = (uvem_mine(probs, cutoff_top, cutoff_low,
                          ignore_label=ignore)[0] if mine else None)
        return p16, hard

    def take(item):
        if item is None:
            return
        indices, arrays = item
        for j, idx in enumerate(indices):
            fname = dataset.filename(idx)
            if keep_in_memory:  # the pinned buffer is reused: a copy
                result[fname] = arrays["prob"][j].copy()
            if out_dir:
                save_prob(os.path.join(out_dir, fname), arrays["prob"][j])
            if mine:
                viz(arrays["hard"][j], fname.replace(".tif", ".png"))

    result: Dict[str, np.ndarray] = {}
    readback = HostReadback()
    for indices, n, _, (p16, hard) in predict_batches(
            net, dataset, mean, std, tile, tta, batch_size, compute_dtype,
            device, capture=capture, epilogue=epilogue):
        host = {"prob": p16[:n]}
        if mine:
            host["hard"] = hard[:n]
        take(readback.push(indices, host))
    take(readback.flush())
    if logger is not None:
        logger.info(f"pseudo labels generated for {len(dataset)} images"
                    + (f" -> {out_dir}" if out_dir else " (in memory)"))
    return result
