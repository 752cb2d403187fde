"""The train steps of stage 1, ``init_prototypes``, stage 2 and stage 3.

The port's copy of ``StageHParams``, ``_forward_train``,
``_source_loss_terms`` (CE or OHEM, with the class balance),
``_target_loss`` (the whole stage-3 zoo), ``make_src_step``,
``make_init_proto_step``, ``make_align_step``, ``make_ssl_step``,
``make_mix_step``, ``make_dca_step`` and ``make_align_simple_step``
(``uemda_tpu/train/steps.py:52-593``; reference ``tools/train_src.py:
108-149``, ``tools/init_prototypes.py:101-111``,
``tools/train_align_uem.py:136-187``, ``tools/train_ssl_uem.py:171-235``,
``tools/train_ssl_mix.py:144-176``, ``tools/train_ssl_dca.py:142-170``,
``tools/train_align.py:126-155``). The adversarial step is
``train/adversarial.py``'s.

Mixed precision as in the JAX package: the f32 master parameters are cast
to ``compute_dtype`` (bf16 by default) for the forward -- a differentiable
cast, so the gradients reach the masters in f32 as through JAX's ``_cast``
(``steps.py:83-103``) -- while BatchNorm and instance-norm statistics, the
losses and the prototype algebra stay f32. A second forward in one step
runs on the BatchNorm running statistics the first has just updated, and
each forward takes its own dropout draw.

Randomness is explicit. A step's draws come from two generators seeded by
(run seed, step index) -- a CPU one for the augmentation (crop origins and
D4 ops, which the host needs to check the crop windows) and one on the
model's device for the dropout masks -- so a step's draws do not depend on
what ran before it, like JAX's ``fold_in(key, step)``. Tests inject the
draws (:class:`StepDraws`) instead.

Under data parallelism (``parallel/mesh.py``) each rank holds its rows of
the global batch: the draws are made for the global batch and sliced to
the rank's rows, every reduction over the batch is global, the step
backpropagates its share of the replicated loss and the optimizer sums the
gradients over the ranks. At world size 1 none of that changes a bit.

A step is two parts: :meth:`_Step.prepare` (the host's: the draws, made
and uploaded) and :meth:`_Step.run` (the device's: no host
synchronisation, and every tensor of the state written in place), which
``train/graph.py`` captures as a CUDA graph and replays.
"""

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from uemda_tpu_torch.alignment.balance import class_balance_weight
from uemda_tpu_torch.alignment.coral import align_domain
from uemda_tpu_torch.alignment.dca import ccr, icr
from uemda_tpu_torch.alignment.losses import (
    cross_entropy_loss,
    focal_loss,
    gdp_loss,
    ghm_loss,
    loss_calc,
    ohem_cross_entropy,
    ups_loss,
    uvem_loss,
)
from uemda_tpu_torch.alignment.pcl import prototype_contrastive_loss
from uemda_tpu_torch.alignment.prototypes import (
    label_refine,
    update_avg,
    update_prototype,
)
from uemda_tpu_torch.datasets.augment import (
    AugDraws,
    augment_batch,
    draw_augment,
    to_device,
    upload_draws,
)
from uemda_tpu_torch.ops.insnorm import instance_norm
from uemda_tpu_torch.ops.labels import downscale_label
from uemda_tpu_torch.ops.mine import uvem_mine
from uemda_tpu_torch.ops.mixing import (
    MixDraws,
    box_mask,
    classmix_mask,
    draw_mix,
    paste,
)
from uemda_tpu_torch.ops.pseudo import pseudo_selection
from uemda_tpu_torch.ops.resize import upsample_logits
from uemda_tpu_torch.parallel import mesh
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
    source_loss: str = "ce"  # 'ce' | 'ohem'
    balance_source: bool = False
    refine: bool = True
    refine_mode: str = "all"
    refine_temp: float = 2.0
    cutoff_top: float = 0.8
    cutoff_low: float = 0.6
    pcl_temp: float = 8.0
    target_loss: str = "uvem"  # one of TARGET_LOSSES
    balance_target: bool = False
    uvem_m: float = 0.2
    uvem_t: float = 0.7
    uvem_g: float = 4.0
    max_segments: int = 2048
    # the stage-3 target Normalize's clamp(max=1.0): ISPRS configs only
    clamp_target: bool = False
    compute_dtype: str = "bfloat16"
    scale_factor: int = 16  # feature stride (output_stride)


TARGET_LOSSES = ("uvem", "ups", "ohem", "focal", "ghm", "gdp", "ce", "none")
# the target losses the target class balance weights (and moves), as
# ``steps.py:263``
BALANCED_TARGET_LOSSES = ("uvem", "ups", "ce", "gdp")


@dataclasses.dataclass
class StepDraws:
    """One step's random draws: augmentation per domain and, optionally,
    the PPM dropout keep-masks per forward ({head name: bool mask}); a
    missing mask is drawn from the step's device generator
    (:func:`draw_dropout_masks`)."""

    aug_s: AugDraws
    aug_t: Optional[AugDraws] = None
    drop_s: Optional[Dict[str, torch.Tensor]] = None
    drop_t: Optional[Dict[str, torch.Tensor]] = None


@dataclasses.dataclass
class MixStepDraws(StepDraws):
    """A mix step's draws: :class:`StepDraws`, the mix draw
    (``ops/mixing.py``) and, for the combo's mining forward, its own
    dropout masks (``drop_m``)."""

    mix: Optional[MixDraws] = None
    drop_m: Optional[Dict[str, torch.Tensor]] = None


def step_generators(seed: int, step: int, device: torch.device
                    ) -> Tuple[torch.Generator, torch.Generator]:
    """(CPU generator for the augmentation, generator on ``device`` for the
    dropout), seeded from (seed, step) only."""
    a, b = np.random.SeedSequence([seed, step]).generate_state(2, np.uint64)
    host = torch.Generator().manual_seed(int(a) >> 1)
    dev = torch.Generator(device=device).manual_seed(int(b) >> 1)
    return host, dev


def global_draws(draws: AugDraws) -> AugDraws:
    """This rank's rows of augmentation draws made for the global batch
    (``parallel/mesh.py``); the draws themselves at world size 1."""
    if mesh.world_size() == 1:
        return draws
    return AugDraws(mesh.shard_rows(draws.offsets), mesh.shard_rows(draws.d4),
                    draws.mode)


def rank_dropout_masks(model, batch: int, crop_hw,
                       generator: torch.Generator) -> Dict[str, torch.Tensor]:
    """:func:`draw_dropout_masks` for the global batch of ``batch`` local
    rows, then this rank's rows: every rank draws the same bits, as one
    rank at the global batch would."""
    masks = draw_dropout_masks(model, batch * mesh.world_size(), crop_hw,
                               generator)
    return {k: mesh.shard_rows(m) for k, m in masks.items()}


def draw_dropout_masks(model, batch: int, crop_hw, generator: torch.Generator
                       ) -> Dict[str, torch.Tensor]:
    """One train forward's PPM dropout keep-masks ({head name: bool}, on
    the generator's device), drawn as the heads would draw them in the
    forward (``heads.py``'s ``Dropout``): the same calls in the same order
    (layer5, then layer6) on the (B, 512, h, w) activation at the feature
    stride. The ASPP head has no dropout: nothing is drawn."""
    cfg = model.config
    if not cfg.use_ppm:
        return {}
    h, w = int(crop_hw[0]), int(crop_hw[1])
    for _ in range(cfg.backbone.output_stride.bit_length() - 1):
        h, w = -(-h // 2), -(-w // 2)   # every stride-2 layer pads to ceil
    keep = 1.0 - model.layer5.conv_last[3].rate
    return {name: torch.rand((batch, 512, h, w), generator=generator,
                             device=generator.device) < keep
            for name in ("layer5", "layer6")}


def cast_params(model: torch.nn.Module, dtype: torch.dtype
                ) -> Optional[Dict[str, torch.Tensor]]:
    """The compute copy of the f32 masters (None: compute in f32 on the
    masters themselves)."""
    if dtype == torch.float32:
        return None
    return {n: p.to(dtype) if p.dtype == torch.float32 else p
            for n, p in model.named_parameters()}


def forward_train(model, params, images: torch.Tensor, dropout_masks):
    """Train-mode forward in the compute dtype of ``params`` (see
    :func:`cast_params`) with the given dropout masks; returns (x1, x2,
    feat) in f32. BatchNorm updates the model's running statistics in
    place."""
    if params is None:
        out = model(images, None, dropout_masks)
    else:
        dtype = next(iter(params.values())).dtype
        out = torch.func.functional_call(
            model, params, (images.to(dtype),),
            {"generator": None, "dropout_masks": dropout_masks})
    return tuple(t.float() for t in out)


def forward_features(model, images: torch.Tensor, dtype: torch.dtype
                     ) -> torch.Tensor:
    """The train-mode feature map ``init_prototypes`` reads, in f32: the
    encoder on batch statistics, then the instance norm (K1). The heads do
    not touch the feature, so they are not run. The JAX step throws the
    forward's new BatchNorm statistics away (``steps.py:174-180``); a
    PyTorch train-mode BatchNorm writes them in place even under
    ``no_grad``, so the encoder runs on scratch copies of its buffers and
    the model's own stay as they were."""
    enc = model.encoder
    params = cast_params(enc, dtype) or dict(enc.named_parameters())
    scratch = {n: b.clone() for n, b in enc.named_buffers()}
    x = images.to(dtype).contiguous(memory_format=torch.channels_last)
    feat = torch.func.functional_call(enc, {**params, **scratch}, (x,))[-1]
    if model.config.is_ins_norm:
        feat = instance_norm(feat)
    return feat.float()


def forward_scratch(model, params, images: torch.Tensor, dropout_masks):
    """:func:`forward_train` on scratch copies of the model's BatchNorm
    buffers, so that its statistics update is thrown away as the JAX
    step's (a PyTorch train-mode BatchNorm writes its buffers even under
    ``no_grad``)."""
    params = params or dict(model.named_parameters())
    scratch = {n: b.clone() for n, b in model.named_buffers()}
    dtype = next(iter(params.values())).dtype
    out = torch.func.functional_call(
        model, {**params, **scratch}, (images.to(dtype),),
        {"generator": None, "dropout_masks": dropout_masks})
    return tuple(t.float() for t in out)


# the state a step replaces with new values (the JAX package's functional
# updates), written back into the tensors it had
_SWAPPED = ("aligner", "balance_s", "balance_t", "ghm")


def _write_back(state: TrainState, kept) -> None:
    """Copy the new values of ``state``'s swapped parts into the tensors
    they had before the step (``kept``) and put those back, so that every
    tensor of the state keeps its address across steps and replays."""
    for name, old in kept.items():
        new = getattr(state, name)
        if new is old or old is None:
            continue
        for f in dataclasses.fields(old):
            a, b = getattr(old, f.name), getattr(new, f.name)
            if isinstance(a, torch.Tensor) and a is not b:
                a.copy_(b)
        setattr(state, name, old)


class _Step:
    """What the stage steps share: the hparams checks, the step's draws and
    augmentation, the compute copy of the masters, the source loss, the
    backward and the update. A subclass computes the losses
    (:meth:`losses`); ``target_mode`` is its target pipeline's D4 mode."""

    needs_target = True
    target_mode = "oneof"

    def __init__(self, model, hp: StageHParams):
        if hp.source_loss not in ("ce", "ohem"):
            raise ValueError(f"unknown source_loss {hp.source_loss!r}")
        cfg = model.config
        if not cfg.multi_layer or cfg.cascade:
            raise NotImplementedError(
                "the train steps take the dual-head model, as the JAX "
                "package's make_src_step and make_align_step")
        self.model = model
        self.hp = hp
        self.dtype = getattr(torch, hp.compute_dtype)

    def losses(self, state, bs, bt, params, draws
               ) -> Dict[str, torch.Tensor]:
        raise NotImplementedError

    def prepare(self, state: TrainState, batch_s, batch_t, seed: int,
                draws: Optional[StepDraws] = None) -> StepDraws:
        """The host's part of a step: its draws from (``seed``,
        ``state.step``) where ``draws`` leaves them out -- augmentation on
        the CPU, checked there, then uploaded; dropout masks from the
        device generator, in the order the forwards would draw them -- all
        on the batches' device."""
        host_gen, dev_gen = step_generators(seed, state.step,
                                            batch_s["image"].device)
        return self._prepare(batch_s, batch_t, draws, host_gen, dev_gen)

    def _prepare(self, batch_s, batch_t, draws, host_gen, dev_gen
                 ) -> StepDraws:
        hp = self.hp
        dev = batch_s["image"].device
        if draws is None:
            def draw(batch, mode):
                # for the global batch, then this rank's rows
                image = batch["image"]
                return global_draws(draw_augment(
                    host_gen, image.shape[0] * mesh.world_size(),
                    image.shape[1:3], hp.crop, mode))

            draws = StepDraws(
                draw(batch_s, "oneof"),
                draw(batch_t, self.target_mode) if self.needs_target else None)

        def masks(given, batch):
            if given is None:
                return rank_dropout_masks(self.model, batch["image"].shape[0],
                                          hp.crop, dev_gen)
            return {k: to_device(m.bool(), dev) for k, m in given.items()}

        def aug(d, batch):
            return upload_draws(d, batch["image"].shape[1:3], hp.crop, dev)

        drop_s = masks(draws.drop_s, batch_s)
        if not self.needs_target:
            return StepDraws(aug(draws.aug_s, batch_s), None, drop_s)
        drop_t = masks(draws.drop_t, batch_t)
        return StepDraws(aug(draws.aug_s, batch_s), aug(draws.aug_t, batch_t),
                         drop_s, drop_t)

    def run(self, state: TrainState, batch_s, batch_t, draws: StepDraws
            ) -> Dict[str, torch.Tensor]:
        """The device's part of a step, on draws from :meth:`prepare` and
        the learning rate in ``state.opt.lr``: forwards, losses, backward
        and the update, with no host synchronisation, every tensor of the
        state written in place. The masters' ``.grad`` keep this step's
        gradients afterwards. Returns the metrics as f32 device scalars.
        This is what ``train/graph.py`` captures."""
        model = self.model
        kept = {k: getattr(state, k) for k in _SWAPPED}
        model.train()
        model.zero_grad(set_to_none=True)
        bs, bt = self._augment(batch_s, batch_t, draws)
        params = cast_params(model, self.dtype)
        metrics = self.losses(state, bs, bt, params, draws)
        mesh.backward(metrics["loss"])
        state.opt.update()
        _write_back(state, kept)
        return {k: v.detach() for k, v in metrics.items()}

    def _augment(self, batch_s, batch_t, draws: StepDraws):
        """The step's crops (K9) and D4 ops: (source, target or None)."""
        hp = self.hp
        bs = augment_batch(batch_s, hp.crop, hp.src_mean, hp.src_std,
                           draws.aug_s)
        bt = None
        if self.needs_target:
            bt = augment_batch(batch_t, hp.crop, hp.tgt_mean, hp.tgt_std,
                               draws.aug_t,
                               clamp=self.target_mode == "compose"
                               and hp.clamp_target)
        return bs, bt

    def __call__(self, state: TrainState, batch_s, batch_t, seed: int,
                 draws: Optional[StepDraws] = None) -> Dict[str, torch.Tensor]:
        """One eager step: :meth:`prepare`, the learning rate, :meth:`run`
        and the host's step count. ``state`` is updated in place."""
        draws = self.prepare(state, batch_s, batch_t, seed, draws)
        state.opt.set_lr()
        metrics = self.run(state, batch_s, batch_t, draws)
        state.advance()
        return metrics

    def _source_fn(self, pixel_weight):
        """The source loss of one head: CE or OHEM (``source_loss``), each
        pixel weighted by ``pixel_weight`` when given."""
        hp = self.hp
        if hp.source_loss == "ohem":
            return lambda lg, lb: ohem_cross_entropy(
                lg, lb, hp.ignore_label, pixel_weight=pixel_weight)
        return lambda lg, lb: cross_entropy_loss(lg, lb, hp.ignore_label,
                                                 pixel_weight)

    def _source_loss(self, state, preds, label) -> torch.Tensor:
        """CE or OHEM over both heads (``_source_loss_terms``,
        ``steps.py:106-122``), each pixel weighted by the class balance with
        ``balance_source``, whose EMA moves first; the new balance goes into
        ``state``."""
        hp = self.hp
        pixel_weight = None
        if hp.balance_source:
            pixel_weight, state.balance_s = class_balance_weight(
                state.balance_s, label, hp.ignore_label)
        return loss_calc(preds, label, self._source_fn(pixel_weight))

    def _seg_and_domain(self, state, p1, p2, label, feat_s, feat_t):
        hp = self.hp
        loss_seg = self._source_loss(state, [p1, p2], label)
        loss_dom = torch.zeros((), device=loss_seg.device)
        if hp.align_domain:
            loss_dom = align_domain(feat_s, feat_t)
        return loss_seg, loss_dom


class SrcStep(_Step):
    """Stage-1 step. ``batch_s``: {'image': (B, H, W, 3) uint8 or f32,
    'label': (B, H, W) int} and ``batch_t``: {'image': ...} on the model's
    device. ``step(state, batch_s, batch_t, seed)`` updates ``state`` in
    place and returns the metrics."""

    @property
    def needs_target(self):
        return self.hp.align_domain

    def losses(self, state, bs, bt, params, draws):
        model = self.model
        p1, p2, feat_s = forward_train(model, params, bs["image"], draws.drop_s)
        feat_t = None
        if self.hp.align_domain:
            _, _, feat_t = forward_train(model, params, bt["image"], draws.drop_t)
        loss_seg, loss_dom = self._seg_and_domain(state, p1, p2, bs["label"],
                                                  feat_s, feat_t)
        return {"loss": loss_seg + loss_dom, "loss_seg": loss_seg,
                "loss_domain": loss_dom}


class AlignStep(_Step):
    """Stage-2 step (``steps.py:185-255``). ``batch_s``: {'image', 'label'};
    ``batch_t``: {'image'} and, for the superpixel view, {'sup': (B, H, W)
    int ids}: the target's supervision is online, from its own forward.

    Order, as the JAX step: source forward; the prototypes' EMA update from
    the source features and labels; target forward (on the BatchNorm
    statistics the source forward just wrote); the target's soft label, the
    mean of both heads' softmax at the crop size, refined by the *updated*
    prototypes and the views of ``refine_mode``; pseudo selection and its
    16x downscale; CE + CORAL + PCL on both domains against the updated
    prototypes."""

    def __init__(self, model, hp: StageHParams):
        super().__init__(model, hp)
        if hp.refine and hp.refine_mode not in ("all", "p", "l", "s", "n"):
            raise ValueError(f"unknown refine_mode {hp.refine_mode!r}")

    def losses(self, state, bs, bt, params, draws):
        hp, model = self.hp, self.model
        p1, p2, feat_s = forward_train(model, params, bs["image"], draws.drop_s)
        aligner, label_s_down = update_prototype(
            state.aligner, feat_s, bs["label"], hp.class_num, hp.scale_factor)
        t1, t2, feat_t = forward_train(model, params, bt["image"], draws.drop_t)
        with torch.no_grad():
            soft = (torch.softmax(upsample_logits(t1, hp.crop), dim=1)
                    + torch.softmax(upsample_logits(t2, hp.crop), dim=1)) * 0.5
            if hp.refine:
                soft = label_refine(aligner, soft, feat_t, [t1, t2],
                                    sup=bt.get("sup"), mode=hp.refine_mode,
                                    temp=hp.refine_temp,
                                    max_segments=hp.max_segments)
            label_t_hard = pseudo_selection(soft, hp.cutoff_top, hp.cutoff_low,
                                            hp.ignore_label)
            label_t_down = downscale_label(label_t_hard, hp.scale_factor,
                                           hp.class_num, hp.ignore_label)
        loss_seg, loss_dom = self._seg_and_domain(state, p1, p2, bs["label"],
                                                  feat_s, feat_t)
        loss_align = 0.5 * (
            prototype_contrastive_loss(aligner.prototypes, feat_s,
                                       label_s_down, hp.pcl_temp,
                                       hp.ignore_label)
            + prototype_contrastive_loss(aligner.prototypes, feat_t,
                                         label_t_down, hp.pcl_temp,
                                         hp.ignore_label))
        state.aligner = aligner
        return {"loss": loss_seg + loss_dom + loss_align, "loss_seg": loss_seg,
                "loss_align": loss_align, "loss_domain": loss_dom}


class SslStep(_Step):
    """Stage-3 step (``steps.py:320-379``). ``batch_s``: {'image', 'label'};
    ``batch_t``: {'image', 'prob': (B, H, W, C) stored soft labels (fp16 or
    f32)} and, for the superpixel view, {'sup'}. The target pipeline is
    ``"compose"``, with the clamp on the ISPRS configs.

    Order, as the JAX step: source forward; target forward (on the
    BatchNorm statistics the source forward just wrote); the stored soft
    label, cropped and turned with the image, refined by the views of
    ``refine_mode`` against the prototypes *before* this step's update;
    one K8 pass (``ops/mine.py``) that gives the hard pseudo label and the
    UVEM ``(w, u)`` both heads' losses read; the prototypes' EMA from the
    source (``train_ssl_uem.py:216``); the source loss, then the target
    loss (``target_loss``, any of :data:`TARGET_LOSSES`); one backward and
    one update. No CORAL and no PCL. The metrics add the
    shares of selected and of trained (u <= t) target pixels and the mean
    UVEM weight."""

    target_mode = "compose"

    def __init__(self, model, hp: StageHParams):
        super().__init__(model, hp)
        if hp.target_loss not in TARGET_LOSSES:
            raise ValueError(f"unknown target_loss {hp.target_loss!r}")
        if hp.refine and hp.refine_mode not in ("all", "p", "l", "s", "n"):
            raise ValueError(f"unknown refine_mode {hp.refine_mode!r}")

    def _target_loss(self, state, preds, label_hard, w, u,
                     paste_mask=None) -> torch.Tensor:
        """``_target_loss`` (``steps.py:258-317``) over both heads: 'uvem'
        and 'ups' read K8's ``(w, u)``; 'ohem', 'focal' (gamma 2) and 'ce'
        the hard label only; 'ghm' and 'gdp' advance ``state.ghm`` head 1,
        then head 2, on the logits upsampled to the label. The target class
        balance weights (and moves for) 'uvem', 'ups', 'ce' and 'gdp'
        only. ``paste_mask`` (the combo mix step): UVEM trains the pasted
        pixels at weight 1, and UPS gates them in (their one-hot soft
        label has entropy 0)."""
        hp = self.hp
        il = hp.ignore_label
        if hp.target_loss == "none":
            return torch.zeros((), device=label_hard.device)
        pixel_weight = None
        if hp.balance_target and hp.target_loss in BALANCED_TARGET_LOSSES:
            pixel_weight, state.balance_t = class_balance_weight(
                state.balance_t, label_hard, il)
        if hp.target_loss in ("ghm", "gdp"):
            hw = tuple(label_hard.shape[-2:])
            ghm, total = state.ghm, 0.0
            for p in preds:
                p = upsample_logits(p, hw)
                if hp.target_loss == "ghm":
                    loss, ghm = ghm_loss(p, label_hard, ghm, il)
                else:
                    loss, ghm = gdp_loss(
                        p, label_hard, ghm, il, pixel_weight=pixel_weight,
                        n_weight_terms=1 + int(pixel_weight is not None))
                total = total + loss
            state.ghm = ghm
            return total / len(preds)
        if hp.target_loss == "uvem":
            fn = lambda lg, lb: uvem_loss(  # noqa: E731
                lg, lb, m=hp.uvem_m, threshold=hp.uvem_t, gamma=hp.uvem_g,
                ignore_label=il, pixel_weight=pixel_weight,
                paste_mask=paste_mask, w=w, u=u)
        elif hp.target_loss == "ups":
            if paste_mask is not None:
                u = torch.where(paste_mask, torch.zeros_like(u), u)
            fn = lambda lg, lb: ups_loss(  # noqa: E731
                lg, lb, threshold=hp.uvem_t, ignore_label=il,
                pixel_weight=pixel_weight, u=u)
        elif hp.target_loss == "ohem":
            fn = lambda lg, lb: ohem_cross_entropy(lg, lb, il)  # noqa: E731
        elif hp.target_loss == "focal":
            fn = lambda lg, lb: focal_loss(lg, lb, 2.0, il)  # noqa: E731
        else:
            fn = lambda lg, lb: cross_entropy_loss(  # noqa: E731
                lg, lb, il, pixel_weight)
        return loss_calc(preds, label_hard, fn)

    def losses(self, state, bs, bt, params, draws):
        hp, model = self.hp, self.model
        p1, p2, feat_s = forward_train(model, params, bs["image"], draws.drop_s)
        t1, t2, feat_t = forward_train(model, params, bt["image"], draws.drop_t)
        with torch.no_grad():
            soft = bt["prob"].permute(0, 3, 1, 2).float()
            if hp.refine:
                soft = label_refine(state.aligner, soft, feat_t, [t1, t2],
                                    sup=bt.get("sup"), mode=hp.refine_mode,
                                    temp=hp.refine_temp,
                                    max_segments=hp.max_segments)
            label_t, w, u = uvem_mine(soft, hp.cutoff_top, hp.cutoff_low,
                                      hp.uvem_m, hp.uvem_t, hp.uvem_g,
                                      hp.ignore_label)
        state.aligner, _ = update_prototype(state.aligner, feat_s, bs["label"],
                                            hp.class_num, hp.scale_factor)
        loss_src = self._source_loss(state, [p1, p2], bs["label"])
        loss_tgt = self._target_loss(state, [t1, t2], label_t, w, u)
        with torch.no_grad():
            selected = mesh.gmean((label_t != hp.ignore_label).float())
            trained = mesh.gmean((u <= hp.uvem_t).float())
        return {"loss": loss_src + loss_tgt, "loss_source": loss_src,
                "loss_target": loss_tgt, "selected": selected,
                "trained": trained, "w_mean": mesh.gmean(w)}


class MixStep(SslStep):
    """ClassMix / CutMix self-training step (``steps.py:382-484``; reference
    ``tools/train_ssl_mix.py:144-176``). Batches as :class:`SslStep`'s.
    ``mix``: "cutmix", "classmix" or "dacs" (ClassMix, as the JAX step).

    Order, as the JAX step: the target's stored soft label, cropped and
    turned with the image; with ``combo`` and ``hp.refine``, refined on a
    no-grad train-mode forward of the unmixed target (its own dropout
    masks, its BatchNorm update thrown away: :func:`forward_scratch`) by
    the prototypes before this step's update; one K8 pass on it, giving
    the hard label (``pseudo_selection``'s) and UVEM's ``(w, u)``; source
    pixels pasted into the target image and hard label; source forward,
    then the mixed target's. The legacy step (no ``combo``) takes the
    source loss (CE or OHEM) on both batches, the target's weighted by the
    source class balance as it was before this step's update, which is
    then thrown away (JAX passes the step's input state). The combo takes
    the target loss (any of the zoo, :meth:`SslStep._target_loss`) against
    the mixed hard label, with the paste mask: UVEM trains pasted pixels
    at weight 1, UPS gates them in, and ``(w, u)`` of the unmixed soft
    label equal the pasted map's off the paste. Then the prototypes' EMA
    from the source. One backward and one update. The metrics are the JAX
    step's: loss, source and target loss."""

    def __init__(self, model, hp: StageHParams, mix: str = "cutmix",
                 combo: bool = False):
        super().__init__(model, hp)
        if mix not in ("cutmix", "classmix", "dacs"):
            raise ValueError(f"unknown mix {mix!r}")
        self.mix = mix
        self.combo = combo

    @property
    def mining_forward(self) -> bool:
        return self.combo and self.hp.refine

    def prepare(self, state: TrainState, batch_s, batch_t, seed: int,
                draws: Optional[MixStepDraws] = None) -> MixStepDraws:
        """:meth:`_Step.prepare`, then the mix draw from the same host
        generator (:func:`ops.mixing.draw_mix`) and, for the mining
        forward, its dropout masks from the device generator, where
        ``draws`` leaves them out; all on the batches' device."""
        hp = self.hp
        dev = batch_s["image"].device
        host_gen, dev_gen = step_generators(seed, state.step, dev)
        base = self._prepare(batch_s, batch_t, draws, host_gen, dev_gen)
        mix = draws.mix if draws is not None else None
        if mix is None:
            mix = draw_mix(host_gen, self.mix, hp.crop, hp.class_num)
        drop_m = draws.drop_m if draws is not None else None
        if self.mining_forward:
            if drop_m is None:
                drop_m = rank_dropout_masks(self.model,
                                            batch_t["image"].shape[0],
                                            hp.crop, dev_gen)
            drop_m = {k: to_device(m.bool(), dev) for k, m in drop_m.items()}
        else:
            drop_m = None
        return MixStepDraws(**{f.name: getattr(base, f.name)
                               for f in dataclasses.fields(base)},
                            mix=mix.to(dev), drop_m=drop_m)

    def losses(self, state, bs, bt, params, draws):
        hp, model = self.hp, self.model
        with torch.no_grad():
            soft = bt["prob"].permute(0, 3, 1, 2).float()
            if self.mining_forward:
                m1, m2, feat_m = forward_scratch(model, params, bt["image"],
                                                 draws.drop_m)
                soft = label_refine(state.aligner, soft, feat_m, [m1, m2],
                                    sup=bt.get("sup"), mode=hp.refine_mode,
                                    temp=hp.refine_temp,
                                    max_segments=hp.max_segments)
            label_t, w, u = uvem_mine(soft, hp.cutoff_top, hp.cutoff_low,
                                      hp.uvem_m, hp.uvem_t, hp.uvem_g,
                                      hp.ignore_label)
            lab_s = bs["label"]
            if self.mix == "cutmix":
                mask = box_mask(hp.crop, draws.mix.lam, draws.mix.cx,
                                draws.mix.cy).expand(label_t.shape)
            else:
                mask = classmix_mask(draws.mix.selected, lab_s, hp.class_num,
                                     hp.ignore_label)
            _, _, img_t, lab_t = paste(mask, bs["image"], lab_s, bt["image"],
                                       label_t)
        balance_s = state.balance_s
        p1, p2, feat_s = forward_train(model, params, bs["image"], draws.drop_s)
        t1, t2, _ = forward_train(model, params, img_t, draws.drop_t)
        loss_s = self._source_loss(state, [p1, p2], lab_s)
        if self.combo:
            loss_t = self._target_loss(state, [t1, t2], lab_t, w, u,
                                       paste_mask=mask)
            state.aligner, _ = update_prototype(
                state.aligner, feat_s, lab_s, hp.class_num, hp.scale_factor)
        else:
            pixel_weight = None
            if hp.balance_source:
                pixel_weight, _ = class_balance_weight(balance_s, lab_t,
                                                       hp.ignore_label)
            loss_t = loss_calc([t1, t2], lab_t, self._source_fn(pixel_weight))
        return {"loss": loss_s + loss_t, "loss_source": loss_s,
                "loss_target": loss_t}


class AlignSimpleStep(_Step):
    """PROCA's stage-2 step, PCL alignment without refinement
    (``make_align_simple_step``, ``steps.py:536-593``; reference
    ``tools/train_align.py:126-155``). Batches as :class:`AlignStep`'s,
    without 'sup'.

    Order, as the JAX step: source forward; the prototypes' EMA update from
    the source features and labels; target forward; the target's label at
    the feature stride, the arg-max of both heads' averaged f32 softmax
    where its max reaches ``conf_thresh`` (ignored elsewhere); CE or OHEM +
    CORAL + the mean of the two PCL terms against the updated prototypes.
    No refinement, so no K5 or K7."""

    def __init__(self, model, hp: StageHParams, conf_thresh: float = 0.9):
        super().__init__(model, hp)
        self.conf_thresh = float(conf_thresh)

    def losses(self, state, bs, bt, params, draws):
        hp, model = self.hp, self.model
        p1, p2, feat_s = forward_train(model, params, bs["image"], draws.drop_s)
        aligner, label_s_down = update_prototype(
            state.aligner, feat_s, bs["label"], hp.class_num, hp.scale_factor)
        t1, t2, feat_t = forward_train(model, params, bt["image"], draws.drop_t)
        with torch.no_grad():
            soft = (torch.softmax(t1, dim=1) + torch.softmax(t2, dim=1)) * 0.5
            label_t = torch.where(
                soft.amax(dim=1) < self.conf_thresh,
                torch.full_like(label_s_down, hp.ignore_label),
                soft.argmax(dim=1).to(label_s_down.dtype))
        loss_seg, loss_dom = self._seg_and_domain(state, p1, p2, bs["label"],
                                                  feat_s, feat_t)
        loss_align = 0.5 * (
            prototype_contrastive_loss(aligner.prototypes, feat_s,
                                       label_s_down, hp.pcl_temp,
                                       hp.ignore_label)
            + prototype_contrastive_loss(aligner.prototypes, feat_t, label_t,
                                         hp.pcl_temp, hp.ignore_label))
        state.aligner = aligner
        return {"loss": loss_seg + loss_dom + loss_align, "loss_seg": loss_seg,
                "loss_align": loss_align, "loss_domain": loss_dom}


class DcaStep(_Step):
    """Self-training with DCA's class-correlation regularizers
    (``make_dca_step``, ``steps.py:487-527``; reference
    ``tools/train_ssl_dca.py:142-170``). Batches as :class:`SslStep`'s,
    without 'sup'.

    Order, as the JAX step: the stored soft label, cropped and turned with
    the image ("compose", with the clamp), and its hard label by
    ``pseudo_selection`` (no refinement, no K8); source forward, then
    target forward; the source loss (CE or OHEM) on both domains -- with
    ``balance_source`` both weighted by the class balance the step started
    with, each after its own EMA update of it, and only the source's new
    balance kept (``steps.py:513-514``); ICR on the source and CCR across
    the domains on the stride-16 logits and features. One backward and one
    update."""

    target_mode = "compose"

    def losses(self, state, bs, bt, params, draws):
        hp, model = self.hp, self.model
        with torch.no_grad():
            label_t = pseudo_selection(bt["prob"].permute(0, 3, 1, 2).float(),
                                       hp.cutoff_top, hp.cutoff_low,
                                       hp.ignore_label)
        balance_s = state.balance_s
        p1, p2, feat_s = forward_train(model, params, bs["image"], draws.drop_s)
        t1, t2, feat_t = forward_train(model, params, bt["image"], draws.drop_t)
        loss_s = self._source_loss(state, [p1, p2], bs["label"])
        pixel_weight = None
        if hp.balance_source:
            pixel_weight, _ = class_balance_weight(balance_s, label_t,
                                                   hp.ignore_label)
        loss_t = loss_calc([t1, t2], label_t, self._source_fn(pixel_weight))
        loss_icr = icr(p1, p2, feat_s, hp.class_num, ignore_bg=True)
        loss_ccr = ccr(p1, p2, feat_s, t1, t2, feat_t, hp.class_num,
                       ignore_bg=True)
        return {"loss": loss_s + loss_t + loss_icr + loss_ccr,
                "loss_seg": loss_s + loss_t, "loss_icr": loss_icr,
                "loss_ccr": loss_ccr}


class InitProtoStep:
    """The ``init_prototypes`` accumulation pass (``steps.py:167-182``):
    augment a source batch, take the train-mode feature map without moving
    the BatchNorm statistics (:func:`forward_features`), and add its
    per-class sums and counts to ``state.aligner``. ``index`` numbers the
    batch: its augmentation draws come from (seed, index)."""

    def __init__(self, model, hp: StageHParams):
        if model.config.cascade or not model.config.multi_layer:
            raise NotImplementedError(
                "init_prototypes takes the dual-head model's feature, as the "
                "JAX package's make_init_proto_step")
        self.model = model
        self.hp = hp
        self.dtype = getattr(torch, hp.compute_dtype)

    def __call__(self, state: TrainState, batch_s, seed: int, index: int = 0,
                 draws: Optional[AugDraws] = None) -> None:
        hp = self.hp
        if draws is None:
            image = batch_s["image"]
            host_gen, _ = step_generators(seed, index, torch.device("cpu"))
            draws = global_draws(draw_augment(
                host_gen, image.shape[0] * mesh.world_size(),
                image.shape[1:3], hp.crop, "oneof"))
        self.model.train()
        bs = augment_batch(batch_s, hp.crop, hp.src_mean, hp.src_std, draws)
        with torch.no_grad():
            feat = forward_features(self.model, bs["image"], self.dtype)
        state.aligner = update_avg(state.aligner, feat, bs["label"],
                                   hp.class_num, hp.scale_factor)


def make_src_step(model, hp: StageHParams) -> SrcStep:
    return SrcStep(model, hp)


def make_align_step(model, hp: StageHParams) -> AlignStep:
    return AlignStep(model, hp)


def make_align_simple_step(model, hp: StageHParams,
                           conf_thresh: float = 0.9) -> AlignSimpleStep:
    return AlignSimpleStep(model, hp, conf_thresh)


def make_ssl_step(model, hp: StageHParams) -> SslStep:
    return SslStep(model, hp)


def make_mix_step(model, hp: StageHParams, mix: str = "cutmix",
                  combo: bool = False) -> MixStep:
    return MixStep(model, hp, mix, combo)


def make_dca_step(model, hp: StageHParams) -> DcaStep:
    return DcaStep(model, hp)


def make_init_proto_step(model, hp: StageHParams) -> InitProtoStep:
    return InitProtoStep(model, hp)
