"""Resize ops (port of `swinwnet_tpu/ops/resize.py`).

The JAX package writes torch's `interpolate` flavours out as gathers
because `jax.image.resize` antialiases; here they are those calls
themselves: bilinear with `align_corners=False` for the heads, bilinear at
scale 0.5 for the LR training inputs, `nearest-exact` for the 2x masks.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def bilinear_resize(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Bilinear resize of [B, C, H, W], half-pixel mapping, no antialias."""
    if (out_h, out_w) == tuple(x.shape[-2:]):
        return x
    return F.interpolate(x, size=(out_h, out_w), mode="bilinear", align_corners=False)


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
