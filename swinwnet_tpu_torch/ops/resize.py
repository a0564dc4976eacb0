"""Resize ops (port of `swinwnet_tpu/ops/resize.py`).

The reference's three torch `interpolate` flavours: bilinear with
`align_corners=False` for the heads, bilinear at scale 0.5 for the LR
training inputs, `nearest-exact` for the 2x masks.

The bilinear resize is written as the JAX package writes it, with static
per-axis taps and lerp weights (`_axis_weights`), here folded into two
interpolation matrices: `R[out_h, H] @ x @ C^T[W, out_w]`. Its backward is
two more products, so it has no scatter and no atomic add and gives the same
bits on every run; `F.interpolate`'s CUDA backward sums with atomic adds in
whatever order the threads arrive.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from ..core.device import full_fp32


def _axis_weights(out_size: int, in_size: int):
    """Half-pixel (align_corners=False) source taps + lerp weights, static."""
    src = (np.arange(out_size) + 0.5) * (in_size / out_size) - 0.5
    src = np.clip(src, 0.0, in_size - 1)
    lo = np.floor(src).astype(np.int32)
    hi = np.minimum(lo + 1, in_size - 1)
    w_hi = (src - lo).astype(np.float32)
    return lo, hi, w_hi


@functools.lru_cache(maxsize=32)
def interp_matrix(out_size: int, in_size: int, device: str) -> torch.Tensor:
    """[out_size, in_size] fp32 on `device`: row i holds output i's two taps'
    weights (one tap of weight 1 where they coincide). Kept for later calls,
    and built outside inference mode so that a training step may save it
    for its backward."""
    lo, hi, w_hi = _axis_weights(out_size, in_size)
    m = np.zeros((out_size, in_size), np.float32)
    rows = np.arange(out_size)
    np.add.at(m, (rows, lo), 1.0 - w_hi)
    np.add.at(m, (rows, hi), w_hi)
    with torch.inference_mode(False):
        return torch.from_numpy(m).to(device)


def bilinear_resize(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Bilinear resize of [..., H, W], exact torch
    `interpolate(mode='bilinear', align_corners=False)` semantics (up and
    down, no antialias), computed in fp32 at full fp32 and returned in x's
    dtype."""
    H, W = x.shape[-2], x.shape[-1]
    if (out_h, out_w) == (H, W):
        return x
    dev = str(x.device)
    rows, cols = interp_matrix(out_h, H, dev), interp_matrix(out_w, W, dev)
    with full_fp32():
        return (rows @ x.float() @ cols.t()).to(x.dtype)


def bilinear_downscale_half(x: torch.Tensor) -> torch.Tensor:
    """[B, C, H, W] -> [B, C, H//2, W//2], bilinear at scale 0.5 (2x2 average
    pooling when H and W are even)."""
    H, W = x.shape[-2], x.shape[-1]
    if H % 2 == 0 and W % 2 == 0:
        return F.avg_pool2d(x, 2)
    return bilinear_resize(x, H // 2, W // 2)


def nearest_exact_resize(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """[B, C, H, W] -> [B, C, out_h, out_w] with src = floor((dst + 0.5) * in / out)."""
    return F.interpolate(x, size=(out_h, out_w), mode="nearest-exact")
