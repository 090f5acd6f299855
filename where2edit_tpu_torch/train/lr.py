"""Learning-rate schedules (counterpart of where2edit_tpu/train/lr.py)."""

from __future__ import annotations

import math


def styleclip_lr_schedule(initial_lr: float, total_steps: int,
                          rampdown: float = 0.25, rampup: float = 0.05):
    """Cosine ramp-down with a linear warm-up: ``schedule(step)`` → the lr
    as a Python float (0 at step 0)."""

    def schedule(step) -> float:
        t = step / total_steps
        ramp = min(1.0, (1.0 - t) / rampdown)
        ramp = 0.5 - 0.5 * math.cos(ramp * math.pi)
        ramp = ramp * min(1.0, t / rampup)
        return initial_lr * ramp

    return schedule
