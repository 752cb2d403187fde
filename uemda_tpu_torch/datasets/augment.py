"""Input transforms: the eval normalize and the training augmentation.

The port's copy of ``uemda_tpu/datasets/augment.py``. The host ships raw
uint8 tiles; on the device every sample is cropped and normalized by the K9
kernel (``ops/crop.py``), its label cropped at the same origin, and then
both go through the same D4 op. That order is exact: the per-channel
normalize commutes with flips and rot90.

Two pipelines, as the reference's:
  * source (``"oneof"``): RandomCrop + OneOf[hflip, vflip, rot90(k ~ U{0..3})]
    with p = 0.75 + Normalize (``configs/ToVaihingen.py:44-55``);
  * ``"compose"``: RandomCrop + hflip(0.5) + vflip(0.5) + rot90(k=1, 0.5)
    (``uemda/aug/augmentation.py:112-122``).

Every draw comes from an explicit CPU ``torch.Generator``
(:func:`draw_augment`); :func:`augment_batch` applies given draws, so tests
can feed the draws the JAX package derives from its key.
"""

import dataclasses
from typing import Dict, Tuple

import torch

from uemda_tpu_torch.ops.crop import crop_normalize


def normalize(image: torch.Tensor, mean, std, clamp: bool = False) -> torch.Tensor:
    """(B, 3, H, W) image (any dtype) -> (x - mean) / std in f32."""
    mean = torch.as_tensor(mean, dtype=torch.float32, device=image.device)
    std = torch.as_tensor(std, dtype=torch.float32, device=image.device)
    out = (image.float() - mean.view(1, -1, 1, 1)) / std.view(1, -1, 1, 1)
    if clamp:
        out = torch.clamp(out, max=1.0)
    return out


@dataclasses.dataclass
class AugDraws:
    """One batch's augmentation draws, on the CPU.

    ``offsets``: (B, 2) int32 crop origins (top, left). ``d4``: (B, 3)
    int64; for ``"oneof"`` the columns are (apply, choice in {0: hflip,
    1: vflip, 2: rot90}, k90), for ``"compose"`` (hflip, vflip, rot90)."""

    offsets: torch.Tensor
    d4: torch.Tensor
    mode: str = "oneof"


def draw_augment(generator: torch.Generator, batch: int, image_hw,
                 crop_hw, mode: str = "oneof") -> AugDraws:
    """The draws of ``augment.py:34-97`` from a CPU generator: a uniform
    crop origin per sample, then the D4 choice of ``mode``."""
    if mode not in ("oneof", "compose"):
        raise ValueError(f"unknown augmentation mode {mode!r}")
    (h, w), (ch, cw) = image_hw, crop_hw

    def randint(high):
        return torch.randint(0, high, (batch,), generator=generator)

    offsets = torch.stack([randint(max(h - ch, 0) + 1),
                           randint(max(w - cw, 0) + 1)], 1).to(torch.int32)
    if mode == "oneof":
        apply = torch.rand(batch, generator=generator) < 0.75
        d4 = torch.stack([apply.long(), randint(3), randint(4)], 1)
    else:
        d4 = (torch.rand(batch, 3, generator=generator) < 0.5).long()
    return AugDraws(offsets, d4, mode)


def _d4(a: torch.Tensor, d4, mode: str, dims: Tuple[int, int]) -> torch.Tensor:
    """One sample's joint flip/rot90 over its (H, W) ``dims``; rot90 turns
    from the H axis toward the W axis, as ``jnp.rot90(axes=(0, 1))``."""
    hd, wd = dims
    if mode == "oneof":
        apply, choice, k90 = d4
        if not apply:
            return a
        if choice == 0:
            return torch.flip(a, (wd,))
        if choice == 1:
            return torch.flip(a, (hd,))
        return torch.rot90(a, k90, dims) if k90 % 4 else a
    do_h, do_v, do_r = d4
    if do_h:
        a = torch.flip(a, (wd,))
    if do_v:
        a = torch.flip(a, (hd,))
    if do_r:
        a = torch.rot90(a, 1, dims)
    return a


def augment_batch(batch: Dict[str, torch.Tensor], crop_hw, mean, std,
                  draws: AugDraws) -> Dict[str, torch.Tensor]:
    """``batch``: ``image`` (B, H, W, 3) uint8 or f32 and optionally
    ``label`` (B, H, W), on one device. Returns ``image`` as the normalized
    (B, 3, th, tw) f32 channels_last crop (K9) and ``label`` cropped at the
    same origins, both through the same D4 op per sample."""
    th, tw = int(crop_hw[0]), int(crop_hw[1])
    image = crop_normalize(batch["image"], draws.offsets, (th, tw), mean, std)
    d4 = draws.d4.tolist()
    out = {"image": torch.stack([_d4(image[i], d4[i], draws.mode, (1, 2))
                                 for i in range(len(d4))])
           .contiguous(memory_format=torch.channels_last)}
    if "label" in batch:
        lab = batch["label"]
        out["label"] = torch.stack([
            _d4(lab[i, y:y + th, x:x + tw], d4[i], draws.mode, (0, 1))
            for i, (y, x) in enumerate(draws.offsets.tolist())])
    return out
