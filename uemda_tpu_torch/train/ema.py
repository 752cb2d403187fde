"""Exponential moving average of a model's parameters.

The port's copy of ``uemda_tpu/train/ema.py`` (reference
``uemda/utils/ema.py:34-65``, imported by the reference's self-training
tools but dormant): a shadow copy of the parameters, its update
``decay * shadow + (1 - decay) * param`` and the apply/restore swap. The
shadow is a {name: tensor} dict over ``named_parameters()``.
"""

from typing import Dict, Tuple

import torch


def init_ema(module: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """A detached copy of ``module``'s parameters."""
    return {n: p.detach().clone() for n, p in module.named_parameters()}


@torch.no_grad()
def update_ema(shadow: Dict[str, torch.Tensor], module: torch.nn.Module,
               decay: float = 0.999) -> Dict[str, torch.Tensor]:
    """``decay * shadow + (1 - decay) * param`` for each parameter, in
    place on the shadow's tensors; returns the shadow."""
    for n, p in module.named_parameters():
        s = shadow[n]
        s.copy_(decay * s + (1.0 - decay) * p)
    return shadow


@torch.no_grad()
def swap_in_ema(module: torch.nn.Module, shadow: Dict[str, torch.Tensor]
                ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """The reference's apply: ``module``'s parameters take the shadow's
    values; returns (the shadow, a backup of the values they had), and
    ``swap_in_ema(module, backup)`` is the restore."""
    backup = init_ema(module)
    for n, p in module.named_parameters():
        p.copy_(shadow[n])
    return shadow, backup
