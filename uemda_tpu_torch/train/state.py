"""Train state: everything a stage-1 or stage-2 step mutates.

The port's copy of ``uemda_tpu/train/state.py:21-38`` up to stage 2: the
step count, the model (its f32 master parameters and BatchNorm running
statistics), the optimizer (momentum buffers and update count) and the
prototype aligner (``uemda_tpu/train/state.py:26,58-59``). Class balance
and GHM state come with their stages. Unlike the JAX package's pytree, the
state is updated in place: the optimizer writes the masters and BatchNorm
its buffers, so no second copy of the model is held; a step swaps in the
aligner's new state.
"""

import dataclasses
from typing import Optional

from uemda_tpu_torch.alignment.prototypes import AlignerState
from uemda_tpu_torch.models.deeplabv2 import DeeplabV2
from uemda_tpu_torch.train.optim import SGD


@dataclasses.dataclass
class TrainState:
    step: int
    model: DeeplabV2
    opt: SGD
    aligner: Optional[AlignerState] = None

    def apply_gradients(self):
        """One optimizer update from the parameters' ``.grad``; returns the
        gradient norm."""
        norm = self.opt.step()
        self.step += 1
        return norm
