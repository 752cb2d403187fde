"""Superpixel maps for the 's' refinement view: the C++ runtime's binding
(LSC, SLIC, the boundary shrink), the alternative front-ends and the
learned SpixelNet."""

from uemda_tpu_torch.superpixels.native import (
    edge_shrink,
    slic_superpixels,
    superpixels_with_shrink,
)
