"""Seeds and weights: one state dict drawn from `--seed` on the device, which
the benchmark hands to the program and to the reference alike."""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch
from torch import nn

# what each stream of random numbers is drawn for
WEIGHTS, TRAFFIC, SAMPLE = 1, 2, 3


def sub_seed(seed: int, stream: int) -> int:
    """A 63-bit seed for one stream, from any whole `seed` (negative or past
    64 bits included)."""
    ss = np.random.SeedSequence([abs(int(seed)) % 2 ** 128, int(seed < 0), stream])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def _ranges(model: nn.Module) -> Dict[str, tuple]:
    """(low, high) of the uniform draw of every parameter, by name: torch's
    default bound 1/sqrt(fan_in) for products and convolutions (weight and
    bias), xavier for the packed cross-attention projection, LayerNorm
    weights about 1 and biases about 0, relative-position tables at the
    published init's spread (std 0.02), and cross-attention gates well away
    from 0 so that the gated path carries signal."""
    out = {}
    for mname, mod in model.named_modules():
        pre = mname + "." if mname else ""
        if isinstance(mod, (nn.Linear, nn.Conv2d)):
            b = 1.0 / math.sqrt(mod.weight[0].numel())
            out[pre + "weight"] = (-b, b)
            if mod.bias is not None:
                out[pre + "bias"] = (-b, b)
        elif isinstance(mod, nn.LayerNorm):
            out[pre + "weight"] = (0.9, 1.1)
            out[pre + "bias"] = (-0.1, 0.1)
        for pname, p in mod.named_parameters(recurse=False):
            key = pre + pname
            if pname == "relative_position_bias_table":
                r = 0.02 * math.sqrt(3.0)
                out[key] = (-r, r)
            elif pname == "in_proj_weight":
                r = math.sqrt(6.0 / (p.shape[0] + p.shape[1]))
                out[key] = (-r, r)
            elif pname == "in_proj_bias":
                out[key] = (-0.02, 0.02)
            elif pname == "gamma":
                out[key] = (0.25, 0.75)
    return out


def draw_state_dict(model: nn.Module, seed: int, device) -> Dict[str, torch.Tensor]:
    """Every parameter of `model` (the reference, built on any device), drawn
    from `seed` with one generator on `device` in one call, fp32."""
    ranges = _ranges(model)
    params = list(model.named_parameters())
    missing = [n for n, _ in params if n not in ranges]
    if missing:
        raise KeyError(f"no draw rule for parameters {missing[:5]}")
    total = sum(p.numel() for _, p in params)
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, WEIGHTS))
    flat = torch.rand(total, generator=gen, device=device, dtype=torch.float32)
    out, at = {}, 0
    for name, p in params:
        lo, hi = ranges[name]
        out[name] = flat[at:at + p.numel()].view(p.shape).mul_(hi - lo).add_(lo)
        at += p.numel()
    return out
