"""Optimizer: SGD with momentum and weight decay after global-norm gradient
clipping, and stage freezing.

The port's copy of ``uemda_tpu/train/optim.py:20-80``, the optax chain
clip_by_global_norm(32) -> add_decayed_weights(5e-4) -> trace(0.9) ->
scale_by_learning_rate(schedule), then the freeze mask (reference:
``clip_grad_norm_(32)`` + ``optim.SGD(lr, momentum=0.9,
weight_decay=5e-4)``, ``tools/train_src.py:106-141``). As optax does:

* the clip scales by ``(g / norm) * max_norm`` when ``norm >= max_norm``,
  with no epsilon;
* the norm counts every gradient, frozen parameters' too, because the mask
  comes after the clip;
* weight decay covers every parameter, BatchNorm's included;
* the schedule reads the number of updates made so far, so update k uses
  lr(k).

The update runs in place on the f32 masters and momentum buffers with
``torch._foreach`` ops, reads the learning rate from a device scalar and
makes no host synchronisation, so a CUDA graph can capture it
(``train/graph.py``).

Gradient accumulation (``accum_steps`` k > 1) is ``optax.MultiSteps(tx,
every_k_schedule=k)`` (``uemda_tpu/train/optim.py:76-79``): each
micro-step folds its gradient into a running mean, ``acc + (g - acc) /
(mini_step + 1)``; the k-th applies the chain above to that mean and
zeroes it, the others leave the masters and the momentum as they were.
Clipping, weight decay and the schedule see the accumulated gradient, and
the schedule advances once per real update. Whether a micro-step applies
is device data (a 0/1 factor written by :meth:`SGD.set_lr` with the
learning rate), so one captured update serves every micro-step: the
masters move by ``update * 1`` or ``* 0`` and the momentum and running
mean blend with 0/1 weights, exact for finite values.
"""

from typing import Callable, Dict, List, Sequence

import torch

from uemda_tpu_torch.parallel import mesh
from uemda_tpu_torch.utils import trace

FREEZE_SUBTREES = {
    # freeze_at levels -> trunk children (resnet.py:119-130)
    1: ["conv1", "bn1", "stem"],
    2: ["layer1"],
    3: ["layer2"],
    4: ["layer3"],
    5: ["layer4"],
}


def freeze_mask(named_params: Sequence, freeze_at: int) -> Dict[str, bool]:
    """{parameter name: trainable}. Only a subtree directly under the trunk
    (``encoder.resnet.<name>``) counts, so a block's own conv1/bn1 is not
    the stem's."""
    frozen = set()
    for lvl in range(1, freeze_at + 1):
        frozen.update(FREEZE_SUBTREES.get(lvl, []))
    out = {}
    for name, _ in named_params:
        parts = name.split(".")
        out[name] = not (parts[:2] == ["encoder", "resnet"] and len(parts) > 2
                         and parts[2] in frozen)
    return out


class SGD:
    """The optax chain above over ``params`` (name, f32 tensor) pairs,
    reading each parameter's ``.grad``. ``trainable``: {name: bool} from
    :func:`freeze_mask`, or None for all. ``accum_steps`` k: one update on
    the mean gradient of k micro-steps (module docstring); :attr:`count`
    counts the updates made, :attr:`mini_step` the micro-steps folded into
    :attr:`acc` since the last one."""

    def __init__(self, named_params: Sequence, schedule: Callable[[int], float],
                 momentum: float = 0.9, weight_decay: float = 5e-4,
                 clip_norm: float = 32.0, trainable: Dict[str, bool] = None,
                 accum_steps: int = 1):
        if accum_steps < 1:
            raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
        self.names = [n for n, _ in named_params]
        self.params: List[torch.Tensor] = [p for _, p in named_params]
        self.schedule = schedule
        self.momentum = momentum
        self.weight_decay = weight_decay
        self.clip_norm = clip_norm
        self.trainable = [True if trainable is None else trainable[n]
                          for n in self.names]
        self.trace = [torch.zeros_like(p) for p in self.params]
        self.count = 0
        # the learning rate of the next update, on the parameters' device:
        # written by set_lr before each update, read by update(), so a
        # captured update replays with each step's rate
        dev = self.params[0].device
        self.lr = torch.zeros((), dtype=torch.float32, device=dev)
        self.accum_steps = int(accum_steps)
        self.mini_step = 0
        self.acc: List[torch.Tensor] = []
        if self.accum_steps > 1:
            self.acc = [torch.zeros_like(p) for p in self.params]
            # mini_step + 1 (the running mean's divisor) and whether this
            # micro-step applies (1.0) or only accumulates (0.0)
            self.acc_div = torch.ones((), dtype=torch.float32, device=dev)
            self.emit = torch.zeros((), dtype=torch.float32, device=dev)

    def set_lr(self) -> None:
        """Write lr(count) into :attr:`lr` -- and with accumulation the
        micro-step's divisor and 0/1 apply factor -- as fills on the device,
        no host synchronisation."""
        self.lr.fill_(self.schedule(self.count))
        if self.accum_steps > 1:
            self.acc_div.fill_(float(self.mini_step + 1))
            self.emit.fill_(float(self.mini_step == self.accum_steps - 1))

    def advance(self) -> None:
        """The host's count of one micro-step taken: with accumulation the
        update count moves only on the micro-step that applied."""
        if self.accum_steps == 1:
            self.count += 1
            return
        self.mini_step += 1
        if self.mini_step == self.accum_steps:
            self.mini_step = 0
            self.count += 1

    @torch.no_grad()
    def update(self) -> torch.Tensor:
        """The update from the parameters' ``.grad`` at the rate in
        :attr:`lr`, all on the device and in place (masters and momentum
        keep their addresses); returns the global gradient norm (before
        clipping) as a device scalar. Does not advance :attr:`count`.
        Inside a traced step (``utils/trace.py``) the gradients' sum over
        the ranks is the phase ``allreduce`` and the rest ``update``."""
        grads = [p.grad for p in self.params]
        if mesh.world_size() > 1:   # data parallelism: sum over ranks
            trace.phase("allreduce")
            mesh.all_reduce_grads(grads)
        trace.phase("update")
        if any(g is None for g in grads):
            missing = [n for n, g in zip(self.names, grads) if g is None]
            raise RuntimeError(f"no gradient for {missing[:3]} ...")
        if self.accum_steps > 1:
            # optax.MultiSteps' running mean, then the chain on it
            torch._foreach_add_(self.acc, torch._foreach_div(
                torch._foreach_sub(grads, self.acc), self.acc_div))
            grads = self.acc
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        # optax's select(norm < max, g, (g / norm) * max) without a host
        # synchronisation: (g / 1) * 1 is g exactly
        keep = norm < self.clip_norm
        one = torch.ones_like(norm)
        grads = torch._foreach_mul(
            torch._foreach_div(grads, torch.where(keep, one, norm)),
            torch.where(keep, one, torch.full_like(norm, self.clip_norm)))
        u = torch._foreach_add(grads, self.params, alpha=self.weight_decay)
        torch._foreach_add_(u, self.trace, alpha=self.momentum)
        train = [i for i, t in enumerate(self.trainable) if t]
        if self.accum_steps == 1:
            torch._foreach_copy_(self.trace, u)
            step = torch._foreach_mul([self.trace[i] for i in train], -self.lr)
        else:
            # trace * (1 - emit) + u * emit: the new momentum on the k-th
            # micro-step, the old one on the others
            hold = 1.0 - self.emit
            torch._foreach_mul_(self.trace, hold)
            torch._foreach_add_(self.trace, torch._foreach_mul(u, self.emit))
            step = torch._foreach_mul(torch._foreach_mul(
                [self.trace[i] for i in train], -self.lr), self.emit)
            torch._foreach_mul_(self.acc, hold)
        torch._foreach_add_([self.params[i] for i in train], step)
        return norm

    def step(self) -> torch.Tensor:
        """One (micro-)step at lr(count), then :meth:`advance`; returns the
        gradient norm as a device scalar."""
        self.set_lr()
        norm = self.update()
        self.advance()
        return norm
