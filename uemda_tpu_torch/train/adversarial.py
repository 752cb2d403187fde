"""Adversarial output-space domain adaptation (AdaptSegNet style).

The port's copy of ``uemda_tpu/train/adversarial.py:27-118``: the
segmenter (G) is trained on the source loss plus ``lambda_adv`` times a
term that makes the discriminator (D, ``models/discriminator.py``'s
``FCDiscriminator``) take its target softmax maps for source ones; D learns
to tell the source maps (1) from the target maps (0). Both updates run in
one step.

* :class:`Adam` is ``optax.adam(lr, b1, b2)`` with eps 1e-8 outside the
  root and a constant rate: ``mu`` and ``nu`` as optax's moments, the count
  incremented before the bias corrections. The count is device data, so
  one captured step (``train/graph.py``) serves every step, as
  ``train/optim.py``'s SGD.
* :class:`AdvState` holds the segmenter's ``TrainState``, D and D's Adam.
  It delegates ``step``, ``model``, ``opt``, ``aligner`` and ``advance``
  to the segmenter's state and extends ``state_dict`` and
  ``load_state_dict`` with D and its Adam, so ``run_training_loop``,
  ``ChunkRunner``, ``maybe_resume`` and ``AsyncSaver`` drive it as they
  drive a ``TrainState``; ``grad_params`` names D's parameters too, so a
  captured step's D gradients are pointed back after each replay.
* :class:`AdvStep` is a ``_Step`` (``prepare`` / ``run``): the source
  forward, then the target forward on the BatchNorm statistics it wrote;
  G's loss, CE or OHEM on both heads plus ``lambda_adv`` BCE(D(softmax(
  up(target head 2))), 1), D's parameters detached from it, so G's
  backward leaves D's gradients alone (D's part of it taken first, on
  cuDNN's deterministic algorithms); G's update. Then D's: the source
  re-forwarded at the *updated* G with the same dropout masks, its
  BatchNorm update thrown away as JAX throws it away (``forward_scratch``),
  and the target map of G's pass, both detached; D's loss 0.5 (BCE(D(s), 1)
  + BCE(D(t), 0)), its backward (deterministic and without TF32, as
  above) and its Adam update. With ``accum_steps`` k the segmenter updates every k micro-steps
  (``train/optim.py``) and D every micro-step, as ``tools/train_adv.py``
  documents.
"""

import dataclasses
from typing import Dict, List, Sequence

import torch

from uemda_tpu_torch.alignment.extra_losses import bce_logits_loss
from uemda_tpu_torch.models.discriminator import FCDiscriminator
from uemda_tpu_torch.ops.resize import upsample_logits
from uemda_tpu_torch.parallel import mesh
from uemda_tpu_torch.train.state import TrainState
from uemda_tpu_torch.train.steps import (
    _SWAPPED,
    StageHParams,
    StepDraws,
    _Step,
    _write_back,
    cast_params,
    forward_scratch,
    forward_train,
)


class Adam:
    """``optax.adam(lr, b1=b1, b2=b2, eps=eps)`` over ``named_params``
    (name, f32 tensor), reading each parameter's ``.grad``, in place with
    ``torch._foreach`` ops and no host synchronisation."""

    def __init__(self, named_params: Sequence, lr: float, b1: float = 0.9,
                 b2: float = 0.99, eps: float = 1e-8):
        self.names = [n for n, _ in named_params]
        self.params: List[torch.Tensor] = [p for _, p in named_params]
        self.lr, self.b1, self.b2, self.eps = float(lr), b1, b2, eps
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        # the updates made, as f32 on the parameters' device
        self.count = torch.zeros((), dtype=torch.float32,
                                 device=self.params[0].device)

    @torch.no_grad()
    def update(self) -> None:
        grads = [p.grad for p in self.params]
        mesh.all_reduce_grads(grads)   # data parallelism: sum over ranks
        if any(g is None for g in grads):
            missing = [n for n, g in zip(self.names, grads) if g is None]
            raise RuntimeError(f"no gradient for {missing[:3]} ...")
        b1, b2 = self.b1, self.b2
        torch._foreach_mul_(self.mu, b1)
        torch._foreach_add_(self.mu, grads, alpha=1 - b1)
        torch._foreach_mul_(self.nu, b2)
        torch._foreach_addcmul_(self.nu, grads, grads, value=1 - b2)
        self.count.add_(1.0)
        mu_hat = torch._foreach_div(self.mu, 1 - torch.pow(b1, self.count))
        nu_hat = torch._foreach_div(self.nu, 1 - torch.pow(b2, self.count))
        denom = torch._foreach_sqrt(nu_hat)
        torch._foreach_add_(denom, self.eps)
        step = torch._foreach_div(mu_hat, denom)
        torch._foreach_mul_(step, -self.lr)
        torch._foreach_add_(self.params, step)

    def state_dict(self) -> Dict[str, object]:
        return {"mu": list(self.mu), "nu": list(self.nu), "count": self.count}


@dataclasses.dataclass
class AdvState:
    seg: TrainState
    disc: torch.nn.Module
    d_opt: Adam

    @property
    def step(self) -> int:
        return self.seg.step

    @step.setter
    def step(self, value: int) -> None:
        self.seg.step = value

    @property
    def model(self):
        return self.seg.model

    @property
    def opt(self):
        return self.seg.opt

    @property
    def aligner(self):
        return self.seg.aligner

    def advance(self) -> None:
        self.seg.advance()

    def grad_params(self) -> List[torch.Tensor]:
        return self.seg.grad_params() + list(self.d_opt.params)

    def state_dict(self) -> Dict[str, object]:
        """``TrainState.state_dict`` with 'disc' (D's state dict) and
        'd_opt' ({'mu', 'nu': lists, 'count'}): the state's own
        tensors."""
        return {**self.seg.state_dict(), "disc": self.disc.state_dict(),
                "d_opt": self.d_opt.state_dict()}

    @torch.no_grad()
    def load_state_dict(self, sd: Dict[str, object]) -> None:
        """Copy a :meth:`state_dict` into this state's tensors in place,
        after checking every key, shape and dtype of the segmenter's, D's
        and D's Adam's parts; a mismatch raises before anything is
        written."""
        pairs = []

        def pair(dst, src, name):
            if not isinstance(src, torch.Tensor) or \
                    tuple(src.shape) != tuple(dst.shape) or \
                    src.dtype != dst.dtype:
                raise ValueError(f"state dict: {name} does not match the "
                                 f"state's {tuple(dst.shape)} {dst.dtype}")
            pairs.append((dst, src))

        for part in ("disc", "d_opt"):
            if part not in sd:
                raise KeyError(f"state dict: missing {part!r}")
        for k, t in self.disc.state_dict().items():
            if k not in sd["disc"]:
                raise KeyError(f"state dict: missing disc.{k!r}")
            pair(t, sd["disc"][k], f"disc.{k}")
        for part in ("mu", "nu"):
            got = sd["d_opt"].get(part, [])
            own = getattr(self.d_opt, part)
            if len(got) != len(own):
                raise ValueError(f"state dict: d_opt.{part} holds {len(got)} "
                                 f"tensors, D's Adam {len(own)}")
            for n, t, s in zip(self.d_opt.names, own, got):
                pair(t, s, f"d_opt.{part}[{n}]")
        pair(self.d_opt.count, sd["d_opt"].get("count"), "d_opt.count")
        self.seg.load_state_dict(sd)
        for dst, src in pairs:
            dst.copy_(src)


def create_adv_state(seg_state: TrainState, num_classes: int,
                     d_lr: float = 1e-4, seed: int = 0) -> AdvState:
    """D (``FCDiscriminator``, ndf 64, its init drawn from ``seed``) on the
    segmenter's device and its Adam (b1 0.9, b2 0.99, the reference
    adversarial baselines' convention; ``adversarial.py:46-56``)."""
    dev = next(seg_state.model.parameters()).device
    disc = FCDiscriminator(num_classes, device=dev,
                           generator=torch.Generator().manual_seed(seed))
    return AdvState(seg_state, disc,
                    Adam(list(disc.named_parameters()), d_lr, 0.9, 0.99))


class AdvStep(_Step):
    """The G + D step (module docstring). Batches: source {'image',
    'label'}, target {'image'} (no label); the target pipeline is
    'oneof'. ``step(adv, batch_s, batch_t, seed)`` updates ``adv`` in
    place and returns {'loss', 'loss_seg', 'loss_adv', 'loss_d'}."""

    def __init__(self, model, hp: StageHParams, lambda_adv: float = 0.001):
        super().__init__(model, hp)
        self.lambda_adv = float(lambda_adv)

    def run(self, adv: AdvState, batch_s, batch_t, draws: StepDraws
            ) -> Dict[str, torch.Tensor]:
        hp, model, seg, disc = self.hp, self.model, adv.seg, adv.disc
        kept = {k: getattr(seg, k) for k in _SWAPPED}
        model.train()
        model.zero_grad(set_to_none=True)
        disc.zero_grad(set_to_none=True)
        bs, bt = self._augment(batch_s, batch_t, draws)
        params = cast_params(model, self.dtype)
        p1, p2, _ = forward_train(model, params, bs["image"], draws.drop_s)
        loss_seg = self._source_loss(seg, [p1, p2], bs["label"])
        _, t2, _ = forward_train(model, params, bt["image"], draws.drop_t)
        soft_t = torch.softmax(upsample_logits(t2, hp.crop), dim=1)
        frozen = {n: p.detach() for n, p in disc.named_parameters()}
        with _deterministic():
            d_out = torch.func.functional_call(disc, frozen, (soft_t,))
            loss_adv = bce_logits_loss(d_out, torch.ones_like(d_out))
            grad_t, = torch.autograd.grad(loss_adv, soft_t)
        loss = loss_seg + self.lambda_adv * loss_adv
        # the same gradient as loss's, D's part taken above (under data
        # parallelism ``grad_t`` is N times this rank's true share, which
        # mesh.backward's 1/N restores)
        mesh.backward(loss_seg + self.lambda_adv * (soft_t * grad_t).sum())
        seg.opt.update()
        _write_back(seg, kept)

        with torch.no_grad():
            _, s2, _ = forward_scratch(model, cast_params(model, self.dtype),
                                       bs["image"], draws.drop_s)
            soft_s = torch.softmax(upsample_logits(s2, hp.crop), dim=1)
        with _deterministic():
            out_s, out_t = disc(soft_s), disc(soft_t.detach())
            loss_d = 0.5 * (bce_logits_loss(out_s, torch.ones_like(out_s))
                            + bce_logits_loss(out_t, torch.zeros_like(out_t)))
            mesh.backward(loss_d)
        adv.d_opt.update()
        return {"loss": loss.detach(), "loss_seg": loss_seg.detach(),
                "loss_adv": loss_adv.detach(), "loss_d": loss_d.detach()}


def _deterministic():
    """cuDNN restricted to deterministic algorithms and full f32 (no
    TF32), the other flags as they are. Some of cuDNN's backward
    algorithms for D's strided convs add with atomics, and a bit's
    difference in G's gradient flips a bf16 rounding of its masters -- an
    eager step and its CUDA-graph replay, or a run and its resume, would
    part past 1e-4 within three steps. D computes in f32 as the JAX
    package's does, whatever PyTorch's TF32 default. The segmenter's convs
    keep their algorithms: D's gradients are taken inside this, G's
    backward outside."""
    c = torch.backends.cudnn
    return c.flags(enabled=c.enabled, benchmark=c.benchmark,
                   deterministic=True, allow_tf32=False)


def make_adv_step(model, hp: StageHParams, lambda_adv: float = 0.001
                  ) -> AdvStep:
    return AdvStep(model, hp, lambda_adv)
