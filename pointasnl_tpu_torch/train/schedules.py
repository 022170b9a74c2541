"""Learning-rate and BN-momentum schedules, plain functions of the global step
(``pointasnl_tpu/train/schedules.py``):

- staircase exponential LR decay with a 1e-5 floor   <- train.py:95-103
- scheduled BN momentum: min(0.99, 1 - 0.5 * 0.5^t),
  t = floor(step * batch_size / decay_step)           <- train.py:74-77,105-113
"""

from __future__ import annotations

import math
from typing import Callable

BN_INIT_DECAY = 0.5
BN_DECAY_DECAY_RATE = 0.5
BN_DECAY_CLIP = 0.99
LR_FLOOR = 1e-5


def staircase_lr_schedule(base_lr: float, batch_size: int, decay_step: float,
                          decay_rate: float) -> Callable[[int], float]:
    """tf.train.exponential_decay(staircase=True) on samples seen, floored at 1e-5."""

    def schedule(step: int) -> float:
        t = math.floor(step * batch_size / decay_step)
        return max(base_lr * decay_rate ** t, LR_FLOOR)

    return schedule


def bn_momentum_schedule(batch_size: int, decay_step: float) -> Callable[[int], float]:
    """Scheduled BN EMA decay: starts at 0.5, rises toward the 0.99 clip."""

    def schedule(step: int) -> float:
        t = math.floor(step * batch_size / decay_step)
        return min(BN_DECAY_CLIP, 1.0 - BN_INIT_DECAY * BN_DECAY_DECAY_RATE ** t)

    return schedule
