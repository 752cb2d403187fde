"""Palette PNG writer for class-id maps.

The port's copy of ``uemda_tpu/utils/viz.py`` (reference ``VisualizeSegmm``,
``uemda/viz.py:11-28``): a label map is written as a palettized PNG with the
dataset's color map; the ignore label renders as palette entry 255 (black).
PIL is imported on the first write, so hosts without it can import the
package.
"""

import os
from typing import Sequence

import numpy as np


class VisualizeSegmm:
    def __init__(self, out_dir: str, palette: Sequence[int]):
        self.out_dir = out_dir
        self.palette = list(palette) + [0] * (768 - len(palette))
        os.makedirs(out_dir, exist_ok=True)

    def __call__(self, label: np.ndarray, filename: str) -> None:
        from PIL import Image

        arr = np.asarray(label).astype(np.int32)
        arr = np.where(arr < 0, 255, arr).astype(np.uint8)  # ignore -> 255
        im = Image.fromarray(arr, mode="P")
        im.putpalette(self.palette)
        im.save(os.path.join(self.out_dir, filename))
