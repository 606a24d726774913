"""Learning-rate schedules and plateau decay, copied from
``tlie_tpu/training/schedules.py`` as host-side float functions, and the
formula the training loop actually applies each step
(``tlie_tpu/training/scan_loop.py::_traced_lr``)."""

from __future__ import annotations

import math
from typing import NamedTuple


def linear_warmup(step, base_lr, end_step, lr_min=None):
    return base_lr * (step + 1) / end_step


def cosine_annealing(step, base_lr, end_step, lr_min=1e-6):
    count = min(step, end_step)
    cosine_decay = 0.5 * (1 + math.cos(math.pi * count / end_step))
    return (base_lr - lr_min) * cosine_decay + lr_min


def constant_lr(step, base_lr, end_step, lr_min=None):
    return base_lr


class PlateauState(NamedTuple):
    """Carry for reduce-on-plateau."""

    lr: float
    ssm_lr: float
    count: int
    best: float


def reduce_lr_on_plateau(
    state: PlateauState, new_acc: float, factor=0.2, patience=20, lr_min=1e-6
) -> PlateauState:
    lr, ssm_lr, count, best = state
    if new_acc > best:
        count, best = 0, new_acc
    else:
        count += 1
    if count > patience:
        lr, ssm_lr, count = factor * lr, factor * ssm_lr, 0
    lr = max(lr, lr_min)
    ssm_lr = max(ssm_lr, lr_min)
    return PlateauState(lr, ssm_lr, count, best)


def schedule_for_step(step, warmup_steps, total_steps, cosine_anneal, lr, ssm_lr, lr_min):
    """The (lr, ssm_lr) pair for one step by the warmup→cosine/constant
    selection of ``schedules.schedule_for_step``."""
    if warmup_steps and step < warmup_steps:
        fn, end = linear_warmup, warmup_steps
    elif cosine_anneal:
        fn, end = cosine_annealing, total_steps - (warmup_steps or 0)
    else:
        fn, end = constant_lr, None
    return float(fn(step, lr, end, lr_min)), float(fn(step, ssm_lr, end, lr_min))


def lr_for_step(step: int, base_lr: float, warmup: int, total: int, cosine: bool,
                lr_min: float) -> float:
    """The learning rate the loop applies at ``step`` (``_traced_lr``):
    ``base·(step+1)/warmup`` during warmup, then the cosine, whose count
    starts at step 0 and not at the end of warmup:
    ``count = min(step, total − warmup)``.  ``base_lr`` is the plateau's
    current rate, not the config's."""
    if step < warmup:
        return base_lr * (step + 1) / max(warmup, 1)
    if not cosine:
        return base_lr
    end = max(total - warmup, 1)
    decay = 0.5 * (1 + math.cos(math.pi * min(step, end) / end))
    return (base_lr - lr_min) * decay + lr_min
