"""Batched sliding-window inference with optional x8 TTA.

Port of ``uemda_tpu/infer/slide.py`` (reference ``uemda/utils/tools.py:
61-97`` ``pre_slide`` and ``:132-152`` ``tta_predict``): all windows of a
batch of images and all 8 dihedral TTA views go through ONE batched forward;
the views are inverse-transformed and averaged and the windows stitched with
count-normalized overlap accumulation. Layout: NCHW. On the card the whole
predictor is one captured CUDA graph, replayed a batch (``infer/graph.py``),
as the JAX package jits it into one XLA program.
"""

import math
from typing import Callable, Optional, Tuple

import torch

from uemda_tpu_torch.infer.graph import Predictor


def window_grid(hw: Tuple[int, int], tile: Tuple[int, int], overlap: float = 0.5):
    """Window origins replicating pre_slide's arithmetic (tools.py:65-79):
    stride = tile*(1-overlap), last window clamped."""
    h, w = hw
    th, tw = tile
    stride = math.ceil(th * (1 - overlap))
    rows = int(math.ceil(max(h - th, 0) / stride) + 1)
    cols = int(math.ceil(max(w - tw, 0) / stride) + 1)
    coords = []
    for r in range(rows):
        for c in range(cols):
            y2 = min(r * stride + th, h)
            x2 = min(c * stride + tw, w)
            coords.append((max(y2 - th, 0), max(x2 - tw, 0)))
    return coords


# dihedral TTA group: ttach.Compose([HorizontalFlip, Rotate90(0/90/180/270)])
# (tools.py:132-152); mean over g^-1(model(g(x))) for all 8 elements


def _views(x: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) -> (8, B, C, H, W): hflip in {0, 1} x rot90 k in {0..3}."""
    outs = []
    for flip in (False, True):
        base = torch.flip(x, dims=(3,)) if flip else x
        for k in range(4):
            outs.append(torch.rot90(base, k=k, dims=(2, 3)))
    return torch.stack(outs)


def _unviews(y: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`_views` on stacked outputs (8, B, C, H, W) -> mean."""
    outs = []
    i = 0
    for flip in (False, True):
        for k in range(4):
            v = torch.rot90(y[i], k=-k, dims=(2, 3))
            outs.append(torch.flip(v, dims=(3,)) if flip else v)
            i += 1
    return sum(outs) / len(outs)


def make_predictor(
    model: Callable[[torch.Tensor], torch.Tensor],
    tile: Tuple[int, int],
    image_hw: Tuple[int, int],
    tta: bool = False,
    overlap: float = 0.5,
    compute_dtype: torch.dtype = torch.bfloat16,
    capture: bool = True,
    epilogue: Optional[Callable] = None,
) -> Predictor:
    """Returns a :class:`Predictor`: images_norm (B, 3, H, W) -> probs (B,
    C, H, W) f32, the whole slide(+TTA) pipeline (window slicing, views,
    one forward, inverse views, count-normalised stitching), on the card one
    captured CUDA graph (``capture=False``: eager calls). As in the JAX
    package, the batch is the caller's fixed (padded) batch; the caller
    slices the valid rows. ``model`` maps (N, 3, th, tw) in
    ``compute_dtype`` to (N, C, th, tw) probabilities; its weights are the
    caller's, already in the dtype it wants (the fast path's biases stay
    f32 on purpose). ``epilogue``, a function of the stitched
    probabilities, runs inside the same capture, and the call returns its
    result instead (the sweep's fp16 cast and mining). An image smaller
    than the tile in either side raises ``ValueError``, as the JAX
    predictor refuses it (its window slice cannot cut the tile)."""
    if image_hw[0] < tile[0] or image_hw[1] < tile[1]:
        raise ValueError(f"image {tuple(image_hw)} is smaller than the slide "
                         f"tile {tuple(tile)}: every window must lie inside "
                         "the image")
    coords = window_grid(image_hw, tile, overlap)
    th, tw = tile

    @torch.no_grad()
    def predict(images: torch.Tensor):
        b = images.shape[0]
        x = images.to(compute_dtype)
        tiles = torch.cat([x[:, :, y1:y1 + th, x1:x1 + tw] for y1, x1 in coords])
        if tta:
            v = _views(tiles)                              # (8, N, 3, th, tw)
            probs = model(v.reshape((-1,) + v.shape[2:])
                          .contiguous(memory_format=torch.channels_last))
            probs = _unviews(probs.reshape((8,) + tiles.shape[:1]
                                           + probs.shape[1:]).float())
        else:
            probs = model(tiles.contiguous(memory_format=torch.channels_last))
        probs = probs.float()
        c = probs.shape[1]
        full = torch.zeros((b, c) + tuple(image_hw), dtype=torch.float32,
                           device=images.device)
        count = torch.zeros((1, 1) + tuple(image_hw), dtype=torch.float32,
                            device=images.device)
        for i, (y1, x1) in enumerate(coords):
            full[:, :, y1:y1 + th, x1:x1 + tw] += probs[i * b:(i + 1) * b]
            count[:, :, y1:y1 + th, x1:x1 + tw] += 1.0
        out = full / count
        return out if epilogue is None else epilogue(out)

    return Predictor(predict, capture)


def slide_predict(model: Callable[[torch.Tensor], torch.Tensor],
                  images: torch.Tensor, tile: Tuple[int, int] = (512, 512),
                  tta: bool = False,
                  compute_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """One-off slide(+TTA) prediction of ``images`` (B, 3, H, W), normalized
    (``uemda_tpu/infer/slide.py:133-136``): a :func:`make_predictor` for
    their size, called once without a capture (a CUDA graph would be paid
    for one batch), then released. ``model`` as :func:`make_predictor`
    takes it, its weights already in ``compute_dtype``."""
    predictor = make_predictor(model, tile, tuple(images.shape[2:]), tta=tta,
                               compute_dtype=compute_dtype, capture=False)
    try:
        return predictor(images)
    finally:
        predictor.close()
