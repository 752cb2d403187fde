"""EMA class-frequency balancing as functional state.

The port's copy of ``uemda_tpu/alignment/balance.py`` (reference
``ClassBalance``, ``uemda/gast/balance.py:15-78``): an EMA over each batch's
class frequencies among its valid pixels, and per-pixel weights
softmax((1 - freq) / T) normalized by their max. The state is a small
dataclass threaded through the step (``TrainState.balance_s`` for the
source, ``balance_t`` for the target); every update returns a new state.
Exact: the class counts are integer sums of a one-hot in f32 (below 2^24
pixels a batch), and the pixel weight picks its class's weight out of a
one-hot -- an elementwise f32 product and sum, never a matrix product in
TF32 or bf16.
"""

import dataclasses
from typing import Tuple

import torch

from uemda_tpu_torch.ops.labels import index_to_onehot
from uemda_tpu_torch.parallel import mesh


@dataclasses.dataclass
class ClassBalanceState:
    freq: torch.Tensor  # (C,) f32
    decay: float = 0.99
    temperature: float = 0.5

    def replace(self, **changes) -> "ClassBalanceState":
        return dataclasses.replace(self, **changes)


def init_class_balance(class_num: int, decay: float = 0.99,
                       temperature: float = 0.5, device=None
                       ) -> ClassBalanceState:
    """Uniform frequencies 1/C."""
    return ClassBalanceState(
        freq=torch.ones(class_num, dtype=torch.float32, device=device)
        / class_num, decay=decay, temperature=temperature)


def _local_freq(label: torch.Tensor, class_num: int, ignore_label: int
                ) -> torch.Tensor:
    """(balance.py:45-53) the batch's class frequencies over valid pixels,
    over the global batch under data parallelism."""
    oh = index_to_onehot(label, class_num, ignore_label)        # (N, C)
    local_cnt = mesh.gsum((label != ignore_label).sum().float())
    return mesh.gsum(oh.sum(dim=0)) / (local_cnt + 1e-7)


def class_weights(state: ClassBalanceState) -> torch.Tensor:
    """(balance.py:38-43) softmax((1 - freq) / T), normalized by its max."""
    z = (1.0 - state.freq) / state.temperature
    prob = torch.exp(z - z.max())
    prob = prob / prob.sum()
    return prob / (prob.max() + 1e-7)


@torch.no_grad()
def class_balance_weight(state: ClassBalanceState, label: torch.Tensor,
                         ignore_label: int = -1
                         ) -> Tuple[torch.Tensor, ClassBalanceState]:
    """(B, H, W) label -> the (B*H*W,) f32 pixel weight (0 at ignored
    pixels) and the updated state: the EMA first, then the weight from the
    updated frequencies (balance.py:27-36)."""
    c = state.freq.shape[0]
    new_state = state.replace(
        freq=state.decay * state.freq
        + (1.0 - state.decay) * _local_freq(label, c, ignore_label))
    w = class_weights(new_state)
    oh = index_to_onehot(label, c, ignore_label)
    return (oh * w[None, :]).sum(dim=1), new_state
