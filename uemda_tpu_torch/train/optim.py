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

The update runs in place on the f32 masters with ``torch._foreach`` ops and
no host synchronisation. Gradient accumulation (``accum_steps > 1``,
optax.MultiSteps) is not ported yet and raises.
"""

from typing import Callable, Dict, List, Sequence

import torch

FREEZE_SUBTREES = {
    # freeze_at levels -> trunk children (resnet.py:119-130)
    1: ["conv1", "bn1"],
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
    :func:`freeze_mask`, or None for all."""

    def __init__(self, named_params: Sequence, schedule: Callable[[int], float],
                 momentum: float = 0.9, weight_decay: float = 5e-4,
                 clip_norm: float = 32.0, trainable: Dict[str, bool] = None,
                 accum_steps: int = 1):
        if accum_steps > 1:
            raise NotImplementedError(
                "gradient accumulation (accum_steps > 1) is not ported yet "
                "(ROADMAP.md queue A)")
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

    @torch.no_grad()
    def step(self) -> torch.Tensor:
        """One update from the parameters' ``.grad``; returns the global
        gradient norm (before clipping) as a device scalar."""
        grads = [p.grad for p in self.params]
        if any(g is None for g in grads):
            missing = [n for n, g in zip(self.names, grads) if g is None]
            raise RuntimeError(f"no gradient for {missing[:3]} ...")
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        # optax's select(norm < max, g, (g / norm) * max) without a host
        # synchronisation: (g / 1) * 1 is g exactly
        keep = norm < self.clip_norm
        one = torch.ones_like(norm)
        grads = torch._foreach_mul(
            torch._foreach_div(grads, torch.where(keep, one, norm)),
            torch.where(keep, one, torch.full_like(norm, self.clip_norm)))
        u = torch._foreach_add(grads, self.params, alpha=self.weight_decay)
        self.trace = torch._foreach_add(u, self.trace, alpha=self.momentum)
        lr = self.schedule(self.count)
        train = [i for i, t in enumerate(self.trainable) if t]
        torch._foreach_add_([self.params[i] for i in train],
                            torch._foreach_mul([self.trace[i] for i in train],
                                               -lr))
        self.count += 1
        return norm
