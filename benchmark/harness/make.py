"""What the benchmark makes from the run's seed: weights, prototypes and
tile pools, on the device in a few large draws, the same bits for the same
seed.

The pools follow the synthetic data of the project (blocky class regions
of 16 pixels with class colours and noise, a colour shift for the target
domain; a regular 16-pixel superpixel grid whose cell borders carry the
largest id), with a share of the blocks left unlabelled, and stage 3's
stored soft labels peaked on the label by a confidence drawn per block, so
that they hold selected and ambiguous pixels and entropies in all three
branches of the UVEM weight.
"""

import math
from typing import Dict, List, Tuple

import numpy as np
import torch

CELL = 16
# the scale of the BatchNorm that ends each residual branch: near zero, so
# that a block starts near the identity. A deep BatchNorm network at plain
# He init is chaotic: rounding in its forward grows with depth until a
# bf16 step and an f32 step part by as much as steps in any lower
# precision, and no comparison of the two can tell them apart.
LAST_SCALE = 0.1


def generator(seed: int, salt: int, device) -> torch.Generator:
    """A generator on ``device`` for one purpose (``salt``) of the run."""
    s = np.random.SeedSequence([int(seed), int(salt)]).generate_state(1,
                                                                      np.uint64)
    return torch.Generator(device=device).manual_seed(int(s[0]) >> 1)


@torch.no_grad()
def weights(spec: List[Tuple[str, tuple, str]], seed: int, device
            ) -> Dict[str, torch.Tensor]:
    """f32 tensors for ``spec`` (``reference.model.param_spec``): convs
    He-normal over their fan-out, the classifier LeCun-normal, its bias,
    BatchNorm's affine parameters and running statistics spread about
    their neutral values, except that the BatchNorm ending each residual
    branch scales by about :data:`LAST_SCALE` (the small-residual init of
    Goyal et al. 2017, which torchvision offers as ``zero_init_residual``);
    all from one normal draw."""
    sizes = [math.prod(shape) for _, shape, _ in spec]
    z = torch.randn(sum(sizes), generator=generator(seed, 1, device),
                    device=device)
    out, at = {}, 0
    for (name, shape, kind), n in zip(spec, sizes):
        v = z[at:at + n].view(shape)
        at += n
        if kind == "conv":
            v = v * math.sqrt(2.0 / (shape[0] * shape[2] * shape[3]))
        elif kind == "classifier":
            v = v / math.sqrt(shape[1] * shape[2] * shape[3])
        elif kind in ("bias", "bn_bias", "bn_mean"):
            v = 0.1 * v
        elif kind == "bn_weight":
            v = 1.0 + 0.1 * v
        elif kind == "bn_last":
            v = LAST_SCALE * (1.0 + 0.1 * v)
        elif kind == "bn_var":
            v = torch.exp(0.2 * v)
        elif kind == "bn_count":
            v = torch.zeros((), dtype=torch.long, device=device)
        out[name] = v.clone()
    return out


@torch.no_grad()
def prototypes(num_classes: int, channels: int, seed: int, device
               ) -> torch.Tensor:
    """(C, K) prototypes, N(0, 0.01^2): small beside the class means of the
    instance-normed features, so that the EMA's moves show those means
    (the refinement's Pearson distance does not see the scale)."""
    return 0.01 * torch.randn(num_classes, channels,
                              generator=generator(seed, 2, device),
                              device=device)


def grid_superpixels(hw: int) -> np.ndarray:
    """(hw, hw) int32 ids of a 16-pixel grid; the two pixels on each side
    of an inner cell border carry the largest id, (hw / 16)^2."""
    n = (hw // CELL) ** 2
    sup = np.kron(np.arange(n, dtype=np.int32).reshape(hw // CELL, -1),
                  np.ones((CELL, CELL), np.int32))
    ring = np.zeros_like(sup, bool)
    for c0 in range(CELL, hw, CELL):
        ring[c0 - 1:c0 + 1, :] = True
        ring[:, c0 - 1:c0 + 1] = True
    return np.where(ring, n, sup).astype(np.int32)


@torch.no_grad()
def pool(n: int, hw: int, num_classes: int, seed: int, salt: int, device,
         shift: float = 0.0, ignore_share: float = 0.05,
         soft: bool = False, sup: bool = False) -> Dict[str, np.ndarray]:
    """``n`` tiles of ``hw``^2 in host memory: ``image`` uint8 (n, hw, hw,
    3), ``label`` int32 (n, hw, hw) with -1 on ``ignore_share`` of the
    blocks, and with ``soft`` the (n, hw, hw, C) fp16 soft labels, with
    ``sup`` the superpixel grid."""
    g = generator(seed, salt, device)
    nb = hw // CELL
    blocks = torch.randint(0, num_classes, (n, nb, nb), generator=g,
                           device=device)
    label = blocks.repeat_interleave(CELL, 1).repeat_interleave(CELL, 2)
    palette = torch.linspace(40, 215, num_classes, device=device)[:, None] \
        * torch.tensor([1.0, 0.8, 0.6], device=device)
    img = palette[label] + 12.0 * torch.randn(label.shape + (3,),
                                             generator=g, device=device)
    out = {"image": (img + shift).clamp(0, 255).to(torch.uint8)}
    hole = (torch.rand((n, nb, nb), generator=g, device=device)
            < ignore_share).repeat_interleave(CELL, 1).repeat_interleave(
                CELL, 2)
    out["label"] = torch.where(hole, -1, label).to(torch.int32)
    if soft:
        conf = torch.tensor([0.5, 2.0, 4.0, 8.0], device=device)[
            torch.randint(0, 4, (n, nb, nb), generator=g, device=device)]
        conf = conf.repeat_interleave(CELL, 1).repeat_interleave(CELL, 2)
        logit = torch.randn(label.shape + (num_classes,), generator=g,
                            device=device)
        logit += conf[..., None] * torch.nn.functional.one_hot(
            label, num_classes)
        out["prob"] = torch.softmax(logit, -1).to(torch.float16)
    host = {k: v.cpu().numpy() for k, v in out.items()}
    if sup:
        host["sup"] = np.ascontiguousarray(
            np.broadcast_to(grid_superpixels(hw), (n, hw, hw)))
    return host
