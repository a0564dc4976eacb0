"""LR schedule: linear warmup then cosine decay (port of
`swinwnet_tpu/train/schedule.py`). The factor for epoch e is held within
the epoch; the schedule is asked once per optimizer step.
"""

from __future__ import annotations

import math
from typing import Callable


def warmup_cosine_schedule(base_lr: float, warmup_epochs: int, num_epochs: int,
                           steps_per_epoch: int) -> Callable[[int], float]:
    """step -> learning rate."""

    def schedule(step: int) -> float:
        epoch = step // max(steps_per_epoch, 1)
        if epoch < warmup_epochs:
            factor = (epoch + 1.0) / max(warmup_epochs, 1)
        else:
            progress = (epoch - warmup_epochs) / max(num_epochs - warmup_epochs, 1)
            factor = 0.5 * (1.0 + math.cos(math.pi * progress))
        return base_lr * factor

    return schedule
