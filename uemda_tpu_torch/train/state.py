"""Train state: everything a stage-1 step mutates.

The port's copy of the stage-1 part of ``uemda_tpu/train/state.py:21-38``:
the step count, the model (its f32 master parameters and BatchNorm running
statistics) and the optimizer (momentum buffers and update count). The
prototype aligner, class balance and GHM state come with their stages.
Unlike the JAX package's pytree, the state is updated in place: the
optimizer writes the masters and BatchNorm its buffers, so no second copy
of the model is held.
"""

import dataclasses

from uemda_tpu_torch.models.deeplabv2 import DeeplabV2
from uemda_tpu_torch.train.optim import SGD


@dataclasses.dataclass
class TrainState:
    step: int
    model: DeeplabV2
    opt: SGD

    def apply_gradients(self):
        """One optimizer update from the parameters' ``.grad``; returns the
        gradient norm."""
        norm = self.opt.step()
        self.step += 1
        return norm
