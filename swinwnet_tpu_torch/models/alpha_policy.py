"""RL alpha policy: a learned global gain on the SR output (port of
`swinwnet_tpu/models/alpha_policy.py`; reference: RL_policy.py:4-24).

Conv(2->8, 3x3, "SAME") + ReLU + global average pool + Linear(8->1) ->
(mu, std=1); `apply_action(sr_out, alpha) = sr_out * sigmoid(alpha)`. The
submodules are named `conv` and `fc` as in the JAX params, so
`compat.state_dict_from_jax` carries those over unchanged.
"""

from __future__ import annotations

from typing import Optional, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..core.device import full_fp32, resolve_device
from ..ops.conv import conv2d
from .swin_wnet import init_weights


class AlphaPolicy(nn.Module):
    """Built on `device` (default: the CUDA device; "cpu" only when asked)
    with torch-default initial weights drawn from `generator` (None: a
    generator seeded with 0). fp32 throughout, at full fp32, as the JAX
    policy."""

    def __init__(self, device: Optional[Union[str, torch.device]] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        with torch.device("meta"):  # shapes only; weights are drawn below
            self.conv = nn.Conv2d(2, 8, 3, padding=1)
            self.fc = nn.Linear(8, 1)
        self.to_empty(device="cpu")
        init_weights(self, generator)
        self.to(device)

    @full_fp32()
    def forward(self, x: torch.Tensor):
        """x: [B, 2, H, W] (the normalized masked LR pattern) -> (mu, std), each [B, 1]."""
        y = F.relu(conv2d(x, self.conv.weight, self.conv.bias, padding=1))
        mu = self.fc(y.mean(dim=(2, 3)))  # AdaptiveAvgPool2d(1) + Flatten
        return mu, torch.ones_like(mu)  # log_std fixed at 0 (RL_policy.py:17-19)


def apply_action(sr_out: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """sr_out: [B, C, H, W]; alpha: [B, 1] -> gain sigmoid(alpha) per sample."""
    return sr_out * torch.sigmoid(alpha.reshape(-1, 1, 1, 1))
