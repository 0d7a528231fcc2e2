"""LR schedules (reference ``train_utils/lr_schedulers.py``).

Only ``cosine`` is registered in the reference (``lr_schedulers.py:66-68``):
linear warmup, then cosine decay to the floor ``end_lr``
(``lr_schedulers.py:55-63``). A plain ``step -> float``; the train step
sets the optimizer's lr to ``sched(k)`` before update k, so with warmup
step 0 runs at lr 0.
"""

from __future__ import annotations

import math
from typing import Callable


def get_cosine_schedule_with_warmup(
    num_warmup_steps: int,
    num_training_steps: int,
    base_lr: float = 1e-4,
    end_lr: float = 0.0,
    num_cycles: float = 0.5,
) -> Callable[[int], float]:
    """``f(step) -> lr`` (reference ``lr_schedulers.py:55-63``)."""

    def schedule(step: int) -> float:
        step = float(step)
        if step < num_warmup_steps:
            return step / max(1, num_warmup_steps) * base_lr
        progress = (step - num_warmup_steps) / max(1, num_training_steps - num_warmup_steps)
        ratio = max(0.0, 0.5 * (1.0 + math.cos(math.pi * num_cycles * 2.0 * progress)))
        return end_lr + (base_lr - end_lr) * ratio

    return schedule


SCHEDULES = {"cosine": get_cosine_schedule_with_warmup}


def get_scheduler(name: str, num_warmup_steps: int, num_training_steps: int,
                  base_lr: float = 1e-4, end_lr: float = 0.0) -> Callable[[int], float]:
    """Registry lookup (reference ``lr_schedulers.py:70-108``)."""
    if name not in SCHEDULES:
        raise ValueError(f"unknown scheduler {name!r}; available: {list(SCHEDULES)}")
    return SCHEDULES[name](num_warmup_steps, num_training_steps, base_lr, end_lr)
