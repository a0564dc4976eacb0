"""Checkpoints on `torch.save` (port of `swinwnet_tpu/utils/checkpoint.py`):
one file `step_<8 digits>.pt` per step holding any tree of tensors (the
full train state: parameters, optimizer state, step), and
`latest_checkpoint` to resume after a crash. Upstream `.pth` loading lives
in `compat/`."""

from __future__ import annotations

import os
import re
from typing import Any, Optional


import torch


def _path(directory: str, step: int) -> str:
    return os.path.join(os.path.abspath(directory), f"step_{step:08d}.pt")


def save_checkpoint(directory: str, tree: Any, step: int = 0) -> str:
    os.makedirs(directory, exist_ok=True)
    path = _path(directory, step)
    tmp = path + ".tmp"
    torch.save(tree, tmp)
    os.replace(tmp, path)  # a crash mid-write leaves no truncated checkpoint
    return path


def load_checkpoint(path: str, map_location: Any = "cpu") -> Any:
    return torch.load(path, map_location=map_location, weights_only=True)


def latest_checkpoint(directory: str) -> Optional[str]:
    if not os.path.isdir(directory):
        return None
    steps = []
    for name in os.listdir(directory):
        m = re.fullmatch(r"step_(\d+)\.pt", name)
        if m:
            steps.append((int(m.group(1)), name))
    if not steps:
        return None
    return os.path.join(os.path.abspath(directory), max(steps)[1])
