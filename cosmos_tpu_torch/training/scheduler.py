"""Learning-rate and teacher-momentum schedules (counterpart of
``cosmos_tpu/training/scheduler.py``).

Each schedule is a plain function of an integer step (the number of
optimizer updates taken so far) that returns a Python float.  The warm-up is
``base * (step + 1) / warmup_length``, as in the reference.
"""

from __future__ import annotations

import math
from typing import Callable

Schedule = Callable[[int], float]


def _warmup(base: float, warmup_length: int, step: int) -> float:
    return base * (step + 1.0) / max(warmup_length, 1)


def const_lr(base_lr: float, warmup_length: int, steps: int) -> Schedule:
    def fn(step: int) -> float:
        if step < warmup_length:
            return _warmup(base_lr, warmup_length, step)
        return base_lr

    return fn


def const_lr_cooldown(
    base_lr: float,
    warmup_length: int,
    steps: int,
    cooldown_steps: int,
    cooldown_power: float = 1.0,
    cooldown_end_lr: float = 0.0,
) -> Schedule:
    start_cooldown = steps - cooldown_steps

    def fn(step: int) -> float:
        if step < warmup_length:
            return _warmup(base_lr, warmup_length, step)
        if step < start_cooldown:
            return base_lr
        e = step - start_cooldown
        decay = math.pow(1.0 - e / float(steps - start_cooldown),
                         cooldown_power)
        return decay * (base_lr - cooldown_end_lr) + cooldown_end_lr

    return fn


def cosine_lr(base_lr: float, warmup_length: int, steps: int) -> Schedule:
    def fn(step: int) -> float:
        if step < warmup_length:
            return _warmup(base_lr, warmup_length, step)
        e = step - warmup_length
        es = float(max(steps - warmup_length, 1))
        return 0.5 * (1.0 + math.cos(math.pi * e / es)) * base_lr

    return fn


def cosine_scheduler(base_value: float, final_value: float,
                     warmup_length: int, steps: int) -> Schedule:
    """Value schedule (the teacher momentum: base -> final over training)."""

    def fn(step: int) -> float:
        if warmup_length > 0 and step < warmup_length:
            return _warmup(base_value, warmup_length, step)
        e = step - warmup_length
        es = float(max(steps - warmup_length, 1))
        return final_value + 0.5 * (1.0 + math.cos(math.pi * e / es)) * (
            base_value - final_value)

    return fn


def get_lr_scheduler(name: str, base_lr: float, warmup: int, steps: int,
                     cooldown_steps: int = 0, cooldown_power: float = 1.0,
                     cooldown_end_lr: float = 0.0) -> Schedule:
    if name == "cosine":
        return cosine_lr(base_lr, warmup, steps)
    if name == "const":
        return const_lr(base_lr, warmup, steps)
    if name == "const-cooldown":
        return const_lr_cooldown(base_lr, warmup, steps, cooldown_steps,
                                 cooldown_power, cooldown_end_lr)
    raise ValueError(
        f"Unknown scheduler {name}; available: cosine, const, const-cooldown")
