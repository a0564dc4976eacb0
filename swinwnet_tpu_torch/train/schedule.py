"""LR schedule: linear warmup then cosine decay (port of
`swinwnet_tpu/train/schedule.py`). The factor for epoch e is held within
the epoch; the schedule is asked once per optimizer step.

The schedule takes the count of steps taken as a Python int (in float64)
or as an integer tensor, then on the tensor's device in fp32, as optax
evaluates the JAX schedule under jit: an optimizer whose count lives on the
card reads its learning rate there, with no host sync, so a CUDA graph can
capture the update.
"""

from __future__ import annotations

import math
from typing import Callable, Union

import torch


def warmup_cosine_schedule(base_lr: float, warmup_epochs: int, num_epochs: int,
                           steps_per_epoch: int) -> Callable[[Union[int, torch.Tensor]], Union[float, torch.Tensor]]:
    """step -> learning rate (a float for an int step, an fp32 tensor for a
    tensor step)."""
    spe, warm_div, cos_div = max(steps_per_epoch, 1), max(warmup_epochs, 1), max(num_epochs - warmup_epochs, 1)

    def schedule(step):
        if isinstance(step, torch.Tensor):
            epoch = torch.div(step, spe, rounding_mode="floor")
            warm = (epoch + 1.0) / warm_div
            cos = 0.5 * (1.0 + torch.cos(math.pi * ((epoch - warmup_epochs) / cos_div)))
            return base_lr * torch.where(epoch < warmup_epochs, warm, cos)
        epoch = step // spe
        if epoch < warmup_epochs:
            factor = (epoch + 1.0) / warm_div
        else:
            factor = 0.5 * (1.0 + math.cos(math.pi * ((epoch - warmup_epochs) / cos_div)))
        return base_lr * factor

    return schedule
