"""Bilinear resize (port of `swinwnet_tpu/ops/resize.py:bilinear_resize`).

The JAX package writes torch's `interpolate(mode='bilinear',
align_corners=False)` out as a two-tap gather because `jax.image.resize`
antialiases; here it is that call itself.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def bilinear_resize(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Bilinear resize of [B, C, H, W], half-pixel mapping, no antialias."""
    if (out_h, out_w) == tuple(x.shape[-2:]):
        return x
    return F.interpolate(x, size=(out_h, out_w), mode="bilinear", align_corners=False)
