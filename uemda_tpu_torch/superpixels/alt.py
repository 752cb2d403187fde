"""Alternative superpixel front-ends: grid superpixels and SLIC over an LDA
colour projection.

The port's copy of ``uemda_tpu/superpixels/alt.py`` (reference
``uemda/gast/slic/superpixel.py:18-202``, dormant there). The production
path is the C++ runtime (:mod:`uemda_tpu_torch.superpixels.native`).
scikit-learn is imported inside :func:`lda_project` only: hosts without it
import this module.
"""

from typing import Optional, Tuple

import numpy as np


def grid_superpixels(hw: Tuple[int, int], region_size: int = 16) -> np.ndarray:
    """A regular grid of ``region_size`` cells, numbered row by row (the
    degenerate baseline)."""
    h, w = hw
    gy = np.arange(h) // region_size
    gx = np.arange(w) // region_size
    cols = -(-w // region_size)
    return (gy[:, None] * cols + gx[None, :]).astype(np.int32)


def lda_project(image: np.ndarray, labels: Optional[np.ndarray]) -> np.ndarray:
    """Project the colours onto their most class-discriminative axes (LDA
    fitted on the labelled pixels, ids >= 0), each axis stretched to
    [0, 255] and repeated to three channels; without labels, the image as
    f32."""
    from sklearn.discriminant_analysis import LinearDiscriminantAnalysis

    h, w = image.shape[:2]
    x = image.reshape(-1, image.shape[-1]).astype(np.float64)
    if labels is None:
        return image.astype(np.float32)
    y = labels.reshape(-1)
    keep = y >= 0
    lda = LinearDiscriminantAnalysis(n_components=min(2, image.shape[-1] - 1))
    lda.fit(x[keep], y[keep])
    proj = lda.transform(x).reshape(h, w, -1)
    proj = proj - proj.min(axis=(0, 1))
    proj = proj / np.maximum(proj.max(axis=(0, 1)), 1e-9) * 255.0
    if proj.shape[-1] < 3:
        proj = np.concatenate([proj] * 3, axis=-1)[..., :3]
    return proj.astype(np.float32)


def slic_on_projection(
    image: np.ndarray,
    labels: Optional[np.ndarray] = None,
    region_size: int = 16,
    ratio: float = 0.075,
    iterations: int = 100,
):
    """The C++ runtime's superpixels (LSC, its default) over the
    LDA-projected colours: (n, (H, W) int32 labels)."""
    from uemda_tpu_torch.superpixels.native import slic_superpixels

    proj = lda_project(image, labels)
    return slic_superpixels(
        np.clip(proj, 0, 255).astype(np.uint8), region_size, ratio, iterations
    )
