"""Input transforms: the eval normalize and the training augmentation.

The port's copy of ``uemda_tpu/datasets/augment.py``. The host ships raw
uint8 tiles; on the device every sample is cropped and normalized by the K9
kernel (``ops/crop.py``), its label and superpixel map cropped at the same
origin, and then all go through the same D4 op. That order is exact: the
per-channel normalize commutes with flips and rot90.

Two pipelines, as the reference's:
  * source (``"oneof"``): RandomCrop + OneOf[hflip, vflip, rot90(k ~ U{0..3})]
    with p = 0.75 + Normalize (``configs/ToVaihingen.py:44-55``);
  * ``"compose"``: RandomCrop + hflip(0.5) + vflip(0.5) + rot90(k=1, 0.5)
    (``uemda/aug/augmentation.py:112-122``), stage 3's target pipeline, which
    also carries the soft label and, on the ISPRS configs, caps the
    normalized image at 1.0 (``clamp``, fused into K9).

Every draw comes from an explicit CPU ``torch.Generator``
(:func:`draw_augment`); :func:`augment_batch` applies given draws, so tests
can feed the draws the JAX package derives from its key. It reads them on
the device (K9 its origins, the D4 ops a gather index), so a captured train
step replays with each step's own draws.
"""

import dataclasses
from typing import Dict, Tuple

import torch

from uemda_tpu_torch.ops.crop import check_offsets, crop_normalize


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
    """One batch's augmentation draws.

    ``offsets``: (B, 2) int32 crop origins (top, left). ``d4``: (B, 3)
    int64; for ``"oneof"`` the columns are (apply, choice in {0: hflip,
    1: vflip, 2: rot90}, k90), for ``"compose"`` (hflip, vflip, rot90).
    :func:`draw_augment` makes them on the CPU; :func:`upload_draws` checks
    the crop windows there and moves them to the batch's device, where
    :func:`augment_batch` reads them without a host synchronisation."""

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


def to_device(t: torch.Tensor, device) -> torch.Tensor:
    """A small host tensor on ``device``; to the card from pinned memory,
    so the copy neither waits for the device nor holds the host."""
    device = torch.device(device)
    if device.type == "cuda" and t.device.type == "cpu":
        t = t.pin_memory()
    return t.to(device, non_blocking=True)


def upload_draws(draws: AugDraws, image_hw, crop_hw, device) -> AugDraws:
    """The draws on ``device``, after the host check that every crop window
    lies inside the ``image_hw`` tile (K9 reads its origins from device
    memory and does not check them)."""
    off = check_offsets(draws.offsets, image_hw, crop_hw)
    return AugDraws(to_device(torch.from_numpy(off), device),
                    to_device(draws.d4, device), draws.mode)


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


# each mode's D4 ops, numbered as :func:`_op_index` numbers a draw
_OPS = {"oneof": [(0, 0, 0), (1, 0, 0), (1, 1, 0)]
        + [(1, 2, k) for k in range(4)],
        "compose": [(h, v, r) for r in (0, 1) for v in (0, 1) for h in (0, 1)]}
_TABLES: Dict[tuple, torch.Tensor] = {}


def _op_index(d4: torch.Tensor, mode: str) -> torch.Tensor:
    """(B, 3) draws -> (B,) int64 index into ``_OPS[mode]``, on their
    device."""
    if mode == "oneof":
        apply, choice, k90 = d4.unbind(1)
        return apply * (1 + choice + (choice == 2) * (k90 % 4))
    return d4[:, 0] + 2 * d4[:, 1] + 4 * d4[:, 2]


def _source_coords(mode: str, th: int, tw: int, device) -> torch.Tensor:
    """(2, ops, th*tw) int64: for each D4 op of ``mode`` and each output
    pixel of the (th, tw) crop, the (row, column) of the crop it comes from
    -- the op applied to the crop's own coordinate grid."""
    key = (mode, th, tw, str(device))
    hit = _TABLES.get(key)
    if hit is None:
        grid = torch.stack(torch.meshgrid(torch.arange(th), torch.arange(tw),
                                          indexing="ij"))
        hit = torch.stack([
            torch.stack([_d4(grid[i], op, mode, (0, 1)).reshape(-1)
                         for op in _OPS[mode]])
            for i in (0, 1)]).to(device)
        _TABLES[key] = hit
    return hit


def augment_batch(batch: Dict[str, torch.Tensor], crop_hw, mean, std,
                  draws: AugDraws, clamp: bool = False
                  ) -> Dict[str, torch.Tensor]:
    """``batch``: ``image`` (B, H, W, 3) uint8 or f32 and optionally
    ``label`` and ``sup`` (B, H, W) and ``prob`` (B, H, W, C), on one
    device. Returns ``image`` as the normalized (B, 3, th, tw) f32
    channels_last crop (K9; with ``clamp`` capped at 1.0) and the others
    cropped at the same origins, all through the same D4 op per sample
    (``augment.py:100-121``); ``prob`` keeps its dtype and its (B, th, tw,
    C) layout.

    The draws may lie on the CPU (checked and uploaded here) or already on
    the batch's device. Every op is a gather of the crop's pixels at an
    index computed on the device from the draws -- a permutation, so the
    values are exact -- and no draw is read on the host: a captured step
    replays with the draws of each step."""
    th, tw = int(crop_hw[0]), int(crop_hw[1])
    if th != tw:
        raise ValueError(f"augment_batch: the D4 ops need a square crop, got "
                         f"{th}x{tw} (the JAX package's rot90 does too)")
    image = batch["image"]
    b, h, w = image.shape[:3]
    if draws.offsets.device != image.device:
        draws = upload_draws(draws, (h, w), (th, tw), image.device)
    crop = crop_normalize(image, draws.offsets, (th, tw), mean, std, clamp)
    rows, cols = _source_coords(draws.mode, th, tw, image.device)[
        :, _op_index(draws.d4, draws.mode)]                     # (B, th*tw)

    def gather(flat: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        """(B, n, *rest) -> (B, th*tw, *rest) at ``idx`` (B, th*tw)."""
        rest = flat.shape[2:]
        return torch.gather(flat, 1, idx.view(b, -1, *(1,) * len(rest))
                            .expand(b, -1, *rest))

    out = {"image": gather(crop.permute(0, 2, 3, 1).reshape(b, th * tw, 3),
                           rows * tw + cols)
           .view(b, th, tw, 3).permute(0, 3, 1, 2)}
    off = draws.offsets.long()
    tile_idx = (rows + off[:, :1]) * w + cols + off[:, 1:]
    for key in ("label", "sup", "prob"):
        if key in batch:
            m = batch[key]
            out[key] = gather(m.reshape(b, h * w, *m.shape[3:]),
                              tile_idx).view(b, th, tw, *m.shape[3:])
    return out
