"""The stage-1 train step: supervised CE on both heads + optional CORAL.

The port's copy of ``StageHParams``, ``_forward_train``, the CE branch of
``_source_loss_terms`` and ``make_src_step`` (``uemda_tpu/train/steps.py:
52-164``; reference ``tools/train_src.py:108-149``).

Mixed precision as in the JAX package: the f32 master parameters are cast
to ``compute_dtype`` (bf16 by default) for the forward -- a differentiable
cast, so the gradients reach the masters in f32 as through JAX's ``_cast``
(``steps.py:83-103``) -- while BatchNorm and instance-norm statistics and
the losses stay f32. With CORAL, the target forward runs on the BatchNorm
running statistics the source forward has just updated, and each forward
takes its own dropout draw.

Randomness is explicit. A step's draws come from two generators seeded by
(run seed, step index) -- a CPU one for the augmentation (crop origins and
D4 ops, which the host needs to check the crop windows) and one on the
model's device for the dropout masks -- so a step's draws do not depend on
what ran before it, like JAX's ``fold_in(key, step)``. Tests inject the
draws (:class:`StepDraws`) instead.
"""

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from uemda_tpu_torch.alignment.coral import align_domain
from uemda_tpu_torch.alignment.losses import cross_entropy_loss, loss_calc
from uemda_tpu_torch.datasets.augment import AugDraws, augment_batch, draw_augment
from uemda_tpu_torch.train.state import TrainState


@dataclasses.dataclass(frozen=True)
class StageHParams:
    class_num: int
    ignore_label: int = -1
    crop: Tuple[int, int] = (512, 512)
    src_mean: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    src_std: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    tgt_mean: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    tgt_std: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    align_domain: bool = False
    source_loss: str = "ce"  # 'ce' | 'ohem' (not ported yet)
    balance_source: bool = False  # not ported yet
    compute_dtype: str = "bfloat16"


@dataclasses.dataclass
class StepDraws:
    """One step's random draws: augmentation per domain and, optionally,
    the PPM dropout keep-masks per forward ({head name: bool mask}); a
    missing mask is drawn from the step's device generator."""

    aug_s: AugDraws
    aug_t: Optional[AugDraws] = None
    drop_s: Optional[Dict[str, torch.Tensor]] = None
    drop_t: Optional[Dict[str, torch.Tensor]] = None


def step_generators(seed: int, step: int, device: torch.device
                    ) -> Tuple[torch.Generator, torch.Generator]:
    """(CPU generator for the augmentation, generator on ``device`` for the
    dropout), seeded from (seed, step) only."""
    a, b = np.random.SeedSequence([seed, step]).generate_state(2, np.uint64)
    host = torch.Generator().manual_seed(int(a) >> 1)
    dev = torch.Generator(device=device).manual_seed(int(b) >> 1)
    return host, dev


def cast_params(model: torch.nn.Module, dtype: torch.dtype
                ) -> Optional[Dict[str, torch.Tensor]]:
    """The compute copy of the f32 masters (None: compute in f32 on the
    masters themselves)."""
    if dtype == torch.float32:
        return None
    return {n: p.to(dtype) if p.dtype == torch.float32 else p
            for n, p in model.named_parameters()}


def forward_train(model, params, images: torch.Tensor, generator,
                  dropout_masks=None):
    """Train-mode forward in the compute dtype of ``params`` (see
    :func:`cast_params`); returns (x1, x2, feat) in f32. BatchNorm updates
    the model's running statistics in place."""
    if params is None:
        out = model(images, generator, dropout_masks)
    else:
        dtype = next(iter(params.values())).dtype
        out = torch.func.functional_call(
            model, params, (images.to(dtype),),
            {"generator": generator, "dropout_masks": dropout_masks})
    return tuple(t.float() for t in out)


class SrcStep:
    """Stage-1 step. ``batch_s``: {'image': (B, H, W, 3) uint8 or f32,
    'label': (B, H, W) int} and ``batch_t``: {'image': ...} on the model's
    device. ``step(state, batch_s, batch_t, seed)`` updates ``state`` in
    place and returns the metrics as f32 device scalars."""

    def __init__(self, model, hp: StageHParams):
        if hp.source_loss != "ce":
            raise NotImplementedError(
                f"source_loss={hp.source_loss!r}: OHEM is not ported yet "
                "(ROADMAP.md queue A)")
        if hp.balance_source:
            raise NotImplementedError(
                "balance_source: class balancing is not ported yet "
                "(ROADMAP.md queue A)")
        cfg = model.config
        if not cfg.multi_layer or cfg.cascade:
            raise NotImplementedError(
                "the stage-1 step takes the dual-head model, as the JAX "
                "package's make_src_step")
        self.model = model
        self.hp = hp
        self.dtype = getattr(torch, hp.compute_dtype)

    def __call__(self, state: TrainState, batch_s, batch_t, seed: int,
                 draws: Optional[StepDraws] = None) -> Dict[str, torch.Tensor]:
        """Forward(s), losses, backward and the update. The masters' ``.grad``
        keep this step's gradients afterwards."""
        hp, model = self.hp, self.model
        host_gen, dev_gen = step_generators(seed, state.step,
                                            batch_s["image"].device)
        if draws is None:
            def draw(batch):
                image = batch["image"]
                return draw_augment(host_gen, image.shape[0], image.shape[1:3],
                                    hp.crop, "oneof")

            draws = StepDraws(draw(batch_s),
                              draw(batch_t) if hp.align_domain else None)
        model.train()
        model.zero_grad(set_to_none=True)
        bs = augment_batch(batch_s, hp.crop, hp.src_mean, hp.src_std,
                           draws.aug_s)
        if hp.align_domain:
            bt = augment_batch(batch_t, hp.crop, hp.tgt_mean, hp.tgt_std,
                               draws.aug_t)
        params = cast_params(model, self.dtype)
        p1, p2, feat_s = forward_train(model, params, bs["image"], dev_gen,
                                       draws.drop_s)
        loss_seg = loss_calc(
            [p1, p2], bs["label"],
            lambda lg, lb: cross_entropy_loss(lg, lb, hp.ignore_label))
        loss_dom = torch.zeros((), device=loss_seg.device)
        if hp.align_domain:
            _, _, feat_t = forward_train(model, params, bt["image"], dev_gen,
                                         draws.drop_t)
            loss_dom = align_domain(feat_s, feat_t)
        loss = loss_seg + loss_dom
        loss.backward()
        state.apply_gradients()
        return {"loss": loss.detach(), "loss_seg": loss_seg.detach(),
                "loss_domain": loss_dom.detach()}


def make_src_step(model, hp: StageHParams) -> SrcStep:
    return SrcStep(model, hp)
