"""Learning-rate schedule: linear warmup + poly decay.

The port's copy of ``uemda_tpu/train/lr.py:13-26`` (reference
``lr_warmup``/``lr_poly``, ``uemda/utils/tools.py:191-207``): lr = base *
step / preheat during warmup, then base * (1 - step / num_steps)^power, with
num_steps = 1.5 * stop_steps and preheat = stop_steps / 20
(``tools/train_src.py:55-56``). lr(0) = 0: the first update moves no
weight by its gradient.
"""

from typing import Callable


def poly_warmup_schedule(base_lr: float, stop_steps: int, power: float = 0.9,
                         num_steps_factor: float = 1.5,
                         preheat_frac: float = 1.0 / 20.0
                         ) -> Callable[[int], float]:
    num_steps = stop_steps * num_steps_factor
    preheat = int(stop_steps * preheat_frac)

    def schedule(step: int) -> float:
        if step < preheat:
            return base_lr * step / max(preheat, 1)
        return base_lr * (1.0 - step / num_steps) ** power

    return schedule
