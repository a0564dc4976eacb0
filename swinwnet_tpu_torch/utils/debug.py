"""Numerical debugging aids (port of `swinwnet_tpu/utils/debug.py`): a
NaN-check mode and a finiteness check of nested parameter or optimizer
state."""

from __future__ import annotations

import contextlib
from typing import Iterator, Optional

import numpy as np
import torch
from torch import nn


def _leaves(tree, path: str = "") -> Iterator:
    """(path, leaf) of every tensor or array in nested dicts, lists and tuples."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}/{k}" if path else str(k))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}/{i}" if path else str(i))
    elif isinstance(tree, (torch.Tensor, np.ndarray)):
        yield path, tree


def _all_finite(leaf) -> bool:
    if isinstance(leaf, torch.Tensor):
        return not leaf.is_floating_point() or bool(torch.isfinite(leaf).all())
    return not np.issubdtype(leaf.dtype, np.inexact) or bool(np.isfinite(leaf).all())


def assert_finite_pytree(tree, name: str = "pytree") -> None:
    """Raises FloatingPointError naming the first path of `tree` (nested
    dicts, lists and tuples of tensors or arrays: a `state_dict`, an
    optimizer's `state_dict()`) that holds a non-finite value."""
    for path, leaf in _leaves(tree):
        if not _all_finite(leaf):
            raise FloatingPointError(f"non-finite values in {name} at {path}")


@contextlib.contextmanager
def nan_check(model: Optional[nn.Module] = None):
    """Inside the block, the first non-finite result raises: in a backward,
    through `torch.autograd.detect_anomaly` (which names the forward
    operation behind it); in `model`'s forward, through a hook on each of
    its submodules that raises FloatingPointError naming the first module
    whose output is not finite. Every check waits for the device."""

    def check(module, _inputs, output):
        for path, leaf in _leaves(output if isinstance(output, (dict, list, tuple)) else [output]):
            if not _all_finite(leaf):
                raise FloatingPointError(f"non-finite output of {names[module] or 'the model'} ({path})")

    names = {} if model is None else {m: n for n, m in model.named_modules()}
    hooks = [m.register_forward_hook(check) for m in names]
    try:
        with torch.autograd.detect_anomaly(check_nan=True):
            yield
    finally:
        for h in hooks:
            h.remove()
