"""Train state: everything a step of stages 1-3 mutates.

The port's copy of ``uemda_tpu/train/state.py:21-65`` without the GHM state
(which comes with the loss zoo, ROADMAP.md queue A item 8): the step count,
the model (its f32 master parameters and BatchNorm running statistics), the
optimizer (momentum buffers and update count), the prototype aligner and
the source and target class balance. Unlike the JAX package's pytree, the
state is updated in place: the optimizer writes the masters and BatchNorm
its buffers, so no second copy of the model is held; a step swaps in the
aligner's and the class balance's new states.
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

    def apply_gradients(self):
        """One optimizer update from the parameters' ``.grad``; returns the
        gradient norm."""
        norm = self.opt.step()
        self.step += 1
        return norm
