"""Learning-rate schedule: poly (power 0.9) or cosine decay after a linear
warm-up, as a plain function of the step on the host.

Counterpart of `rmem_tpu/ops/schedule.py`, evaluated in f32 as the JAX
package evaluates it inside its step.
"""

from __future__ import annotations

import math

import numpy as np


def make_lr_schedule(base_lr: float, min_lr: float, total_steps: int,
                     power: float = 0.9, warmup_ratio: float = 0.05,
                     cosine: bool = False, restarts: int = 1):
    """Returns lr(step) -> float."""
    f = np.float32
    warm_up_steps = total_steps * warmup_ratio

    def schedule(step) -> float:
        step = f(step)
        max_itr = f(total_steps)
        wu = f(warm_up_steps)
        if restarts > 1:
            each = f(math.ceil(total_steps / restarts))
            step = np.mod(step, each)
            wu = f(warm_up_steps / restarts)
            max_itr = each
        if step < wu:
            return float(f(min_lr) + f(base_lr - min_lr) * step
                         / max(wu, f(1.0)))
        it, mx = step - wu, max_itr - wu
        if cosine:
            decay = f(min_lr) + f(base_lr - min_lr) * (
                np.cos(f(np.pi) * it / (mx + f(1.0))) + f(1.0)) * f(0.5)
        else:
            decay = f(min_lr) + f(base_lr - min_lr) * (
                max(f(1.0) - it / (mx + f(1.0)), f(0.0)) ** f(power))
        return float(decay)

    return schedule


def encoder_lr(now_lr: float, min_lr: float, encoder_ratio: float) -> float:
    """The encoder group's rate: (lr - min) * ratio + min."""
    f = np.float32
    return float((f(now_lr) - f(min_lr)) * f(encoder_ratio) + f(min_lr))
