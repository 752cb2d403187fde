"""Train state: everything a step of stages 1-3 mutates.

The port's copy of ``uemda_tpu/train/state.py:21-65``: the step count
(micro-steps, with gradient accumulation), the model (its f32 master
parameters and BatchNorm running statistics), the optimizer (momentum
buffers, update count and, with accumulation, the running mean of the
micro-steps' gradients), the prototype aligner, the source and target class
balance and the GHM/GDP histogram. Unlike the JAX package's pytree, the
state is updated in place: the optimizer writes the masters and momentum,
BatchNorm its buffers, and a step copies the aligner's and the class
balances' new values into their tensors, so every tensor of the state keeps
its address from step to step (which a captured step needs).

:meth:`TrainState.state_dict` and :meth:`TrainState.load_state_dict` are
the snapshot an exact ``--resume`` needs (``train/checkpoints.py``); the
learning rate is not in it, ``SGD.set_lr`` recomputes it from the count.
"""

import dataclasses
from typing import Dict, List, Optional

import torch

from uemda_tpu_torch.alignment.balance import ClassBalanceState
from uemda_tpu_torch.alignment.losses import GHMState
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
    ghm: Optional[GHMState] = None

    def advance(self) -> None:
        """The host's count of one step taken: the step index and the
        optimizer's counts (``train/steps.py``'s ``_Step.run`` and a
        replay of it make the update without counting it)."""
        self.opt.advance()
        self.step += 1

    def grad_params(self) -> List[torch.Tensor]:
        """The tensors whose ``.grad`` a step writes (``train/graph.py``
        points them back at a captured step's after each replay)."""
        return list(self.opt.params)

    def state_dict(self) -> Dict[str, object]:
        """{'step', 'model' (masters and BatchNorm buffers, the model's
        own key names), 'opt': {'trace': [momentum], 'count'} (with
        accumulation also 'acc': [running mean] and 'mini_step'),
        'aligner': {'prototypes', 'data_sum', 'data_cnt'}, 'balance_s' /
        'balance_t': {"freq"}, 'ghm': {'acc_sum'}}: the state's own
        tensors, not copies (a part that is None is left out)."""
        opt = {"trace": list(self.opt.trace), "count": int(self.opt.count)}
        if self.opt.accum_steps > 1:
            opt.update(acc=list(self.opt.acc),
                       mini_step=int(self.opt.mini_step))
        out = {"step": int(self.step), "model": self.model.state_dict(),
               "opt": opt}
        if self.aligner is not None:
            out["aligner"] = {k: getattr(self.aligner, k) for k in _ALIGNER}
        for name in ("balance_s", "balance_t"):
            if getattr(self, name) is not None:
                out[name] = {"freq": getattr(self, name).freq}
        if self.ghm is not None:
            out["ghm"] = {"acc_sum": self.ghm.acc_sum}
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
        lists = ["trace"] + (["acc"] if self.opt.accum_steps > 1 else [])
        for part in lists:
            got, own = need(opt, part, "opt."), getattr(self.opt, part)
            if len(got) != len(own):
                raise ValueError(f"state dict: opt.{part} holds {len(got)} "
                                 f"tensors, the optimizer {len(own)}")
            for n, t, s in zip(self.opt.names, own, got):
                pair(t, s, f"opt.{part}[{n}]")
        count, step = int(need(opt, "count", "opt.")), int(need(sd, "step", ""))
        mini = (int(need(opt, "mini_step", "opt."))
                if self.opt.accum_steps > 1 else 0)
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
        if self.ghm is not None:
            pair(self.ghm.acc_sum, need(need(sd, "ghm", ""), "acc_sum", "ghm."),
                 "ghm.acc_sum")
        for dst, src in pairs:
            dst.copy_(src)
        self.opt.count, self.opt.mini_step, self.step = count, mini, step
