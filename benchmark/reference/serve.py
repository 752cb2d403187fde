"""The plain reference of the benchmarked serving path, in float32.

Slide inference with 8-view test-time augmentation (reference
``uemda/utils/tools.py:61-97`` ``pre_slide`` and ``:132-152``
``tta_predict``): windows of the tile size at half overlap, the last one in
each direction moved back inside the image; each window seen under the 8
elements of the dihedral group (horizontal flip x four quarter turns), the
model's eval probabilities turned back and averaged; overlapping windows
averaged by their count. The normalization is the eval split's
``(x - mean) / std``.
"""

import math
from typing import List, Tuple

import torch

from benchmark.reference.model import Net


def windows(hw: Tuple[int, int], tile: Tuple[int, int],
            overlap: float = 0.5) -> List[Tuple[int, int]]:
    (h, w), (th, tw) = hw, tile
    stride = math.ceil(th * (1 - overlap))
    rows = int(math.ceil(max(h - th, 0) / stride) + 1)
    cols = int(math.ceil(max(w - tw, 0) / stride) + 1)
    out = []
    for r in range(rows):
        for c in range(cols):
            y2, x2 = min(r * stride + th, h), min(c * stride + tw, w)
            out.append((max(y2 - th, 0), max(x2 - tw, 0)))
    return out


def tta_probs(net: Net, x: torch.Tensor) -> torch.Tensor:
    """(N, 3, h, w) -> (N, C, h, w): the 8 views in one batch, each turned
    back, averaged."""
    views = [torch.rot90(torch.flip(x, (3,)) if flip else x, k, (2, 3))
             for flip in (False, True) for k in range(4)]
    ys = net.eval_probs(torch.cat(views)).split(x.shape[0])
    acc, i = 0.0, 0
    for flip in (False, True):
        for k in range(4):
            y = torch.rot90(ys[i], -k, (2, 3))
            acc = acc + (torch.flip(y, (3,)) if flip else y)
            i += 1
    return acc / 8.0


@torch.no_grad()
def slide_tta(net: Net, image_u8: torch.Tensor, mean, std, tile,
              tta: bool = True) -> torch.Tensor:
    """(H, W, 3) uint8 on the device -> (C, H, W) f32 probabilities, every
    window and view of the image in one batch."""
    dev = image_u8.device
    x = image_u8.permute(2, 0, 1)[None].float()
    x = (x - torch.tensor(mean, device=dev).view(1, 3, 1, 1)) \
        / torch.tensor(std, device=dev).view(1, 3, 1, 1)
    hw = tuple(x.shape[2:])
    coords = windows(hw, tile)
    wins = torch.cat([x[:, :, y1:y1 + tile[0], x1:x1 + tile[1]]
                      for y1, x1 in coords])
    probs = tta_probs(net, wins) if tta else net.eval_probs(wins)
    full = torch.zeros((probs.shape[1],) + hw, device=dev)
    count = torch.zeros(hw, device=dev)
    for i, (y1, x1) in enumerate(coords):
        full[:, y1:y1 + tile[0], x1:x1 + tile[1]] += probs[i]
        count[y1:y1 + tile[0], x1:x1 + tile[1]] += 1.0
    return full / count
