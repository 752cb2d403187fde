"""Train state: everything a step of stages 1-3 mutates.

The port's copy of ``uemda_tpu/train/state.py:21-65`` without the GHM state
(which comes with the loss zoo, ROADMAP.md queue A5): the step count,
the model (its f32 master parameters and BatchNorm running statistics), the
optimizer (momentum buffers and update count), the prototype aligner and
the source and target class balance. Unlike the JAX package's pytree, the
state is updated in place: the optimizer writes the masters and momentum,
BatchNorm its buffers, and a step copies the aligner's and the class
balances' new values into their tensors, so every tensor of the state keeps
its address from step to step (which a captured step needs).

:meth:`TrainState.state_dict` and :meth:`TrainState.load_state_dict` are
the snapshot an exact ``--resume`` needs (``train/checkpoints.py``); the
learning rate is not in it, ``SGD.set_lr`` recomputes it from the count.
"""

import dataclasses
from typing import Dict, Optional

import torch

from uemda_tpu_torch.alignment.balance import ClassBalanceState
from uemda_tpu_torch.alignment.prototypes import AlignerState
from uemda_tpu_torch.models.deeplabv2 import DeeplabV2
from uemda_tpu_torch.train.optim import SGD

_ALIGNER = ("prototypes", "data_sum", "data_cnt")


@dataclasses.dataclass
class TrainState:
    step: int
    model: DeeplabV2
    opt: SGD
    aligner: Optional[AlignerState] = None
    balance_s: Optional[ClassBalanceState] = None
    balance_t: Optional[ClassBalanceState] = None

    def advance(self) -> None:
        """The host's count of one step taken: the step index and the
        optimizer's update count (``train/steps.py``'s ``_Step.run`` and a
        replay of it make the update without counting it)."""
        self.opt.count += 1
        self.step += 1

    def state_dict(self) -> Dict[str, object]:
        """{'step', 'model' (masters and BatchNorm buffers, the model's
        own key names), 'opt': {'trace': [momentum], 'count'}, 'aligner':
        {'prototypes', 'data_sum', 'data_cnt'}, 'balance_s' / 'balance_t':
        {"freq"}}: the state's own tensors, not copies (a part that is
        None is left out)."""
        out = {"step": int(self.step), "model": self.model.state_dict(),
               "opt": {"trace": list(self.opt.trace),
                       "count": int(self.opt.count)}}
        if self.aligner is not None:
            out["aligner"] = {k: getattr(self.aligner, k) for k in _ALIGNER}
        for name in ("balance_s", "balance_t"):
            if getattr(self, name) is not None:
                out[name] = {"freq": getattr(self, name).freq}
        return out

    @torch.no_grad()
    def load_state_dict(self, sd: Dict[str, object]) -> None:
        """Copy a :meth:`state_dict` into this state's tensors in place --
        no tensor is rebound, so a step captured on this state replays on
        the loaded values -- after checking every key, shape and dtype; a
        missing key or a mismatch raises with its name, before anything is
        written."""
        pairs = []

        def need(tree, key, where):
            if not isinstance(tree, dict) or key not in tree:
                raise KeyError(f"state dict: missing {where}{key!r}")
            return tree[key]

        def pair(dst: torch.Tensor, src, name: str):
            if not isinstance(src, torch.Tensor):
                raise TypeError(f"state dict: {name} is not a tensor")
            if tuple(src.shape) != tuple(dst.shape) or src.dtype != dst.dtype:
                raise ValueError(
                    f"state dict: {name} is {tuple(src.shape)} {src.dtype}, "
                    f"the state's is {tuple(dst.shape)} {dst.dtype}")
            pairs.append((dst, src))

        model_sd = need(sd, "model", "")
        for k, t in self.model.state_dict().items():
            pair(t, need(model_sd, k, "model."), f"model.{k}")
        opt = need(sd, "opt", "")
        trace = need(opt, "trace", "opt.")
        if len(trace) != len(self.opt.trace):
            raise ValueError(f"state dict: opt.trace holds {len(trace)} "
                             f"tensors, the optimizer {len(self.opt.trace)}")
        for n, t, s in zip(self.opt.names, self.opt.trace, trace):
            pair(t, s, f"opt.trace[{n}]")
        count, step = int(need(opt, "count", "opt.")), int(need(sd, "step", ""))
        if self.aligner is not None:
            al = need(sd, "aligner", "")
            for k in _ALIGNER:
                pair(getattr(self.aligner, k), need(al, k, "aligner."),
                     f"aligner.{k}")
        for name in ("balance_s", "balance_t"):
            if getattr(self, name) is not None:
                pair(getattr(self, name).freq,
                     need(need(sd, name, ""), "freq", f"{name}."),
                     f"{name}.freq")
        for dst, src in pairs:
            dst.copy_(src)
        self.opt.count, self.step = count, step
