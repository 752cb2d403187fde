"""Train state: everything a step of stages 1-3 mutates.

The port's copy of ``uemda_tpu/train/state.py:21-65`` without the GHM state
(which comes with the loss zoo, ROADMAP.md queue A item 8): the step count,
the model (its f32 master parameters and BatchNorm running statistics), the
optimizer (momentum buffers and update count), the prototype aligner and
the source and target class balance. Unlike the JAX package's pytree, the
state is updated in place: the optimizer writes the masters and momentum,
BatchNorm its buffers, and a step copies the aligner's and the class
balances' new values into their tensors, so every tensor of the state keeps
its address from step to step (which a captured step needs).
"""

import dataclasses
from typing import Optional

from uemda_tpu_torch.alignment.balance import ClassBalanceState
from uemda_tpu_torch.alignment.prototypes import AlignerState
from uemda_tpu_torch.models.deeplabv2 import DeeplabV2
from uemda_tpu_torch.train.optim import SGD


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
