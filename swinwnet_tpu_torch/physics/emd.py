"""Peak-shape Wasserstein-1 (EMD) metrics (port of `swinwnet_tpu/physics/emd.py`).

Profiles are normalized to unit mass, resampled onto a relative grid
``x = (d - d_peak) / d_peak`` over ``linspace(-0.03, 0.03, 64)`` and compared
via W1 = sum |CDF_p - CDF_q| * dx (reference: Diffraction_metrics.py:150-203).
The host functions are those of :mod:`.host_oracle`, re-exported; this
module adds `interp`, `jnp.interp` in torch, which the on-device metrics
resample their profiles with.
"""

from __future__ import annotations

import numpy as np
import torch

from .host_oracle import (  # noqa: F401
    X_REF,
    emd_1d,
    emd_shape_loss,
    normalize_profile,
    resample_profile,
)

_NUMPY_DTYPE = {torch.float32: np.float32, torch.float64: np.float64}


def interp(x: torch.Tensor, xp: torch.Tensor, fp: torch.Tensor, left=None, right=None) -> torch.Tensor:
    """`jnp.interp` over the last axis, batched over the leading ones: x
    [..., m], xp and fp [..., k] with xp sorted. As jax/_src/numpy's
    `_interp`: the interval from a `side='right'` search clipped to [1, k-1],
    the left value where the interval's width is at most spacing(eps) (so
    repeated xp never divide by 0), and `left` / `right` (default fp's first
    / last) outside [xp[0], xp[-1]]."""
    k = xp.shape[-1]
    i = torch.searchsorted(xp.contiguous(), x.contiguous(), right=True).clamp(1, k - 1)
    xp0, xp1 = xp.gather(-1, i - 1), xp.gather(-1, i)
    fp0, fp1 = fp.gather(-1, i - 1), fp.gather(-1, i)
    df = fp1 - fp0
    dx = xp1 - xp0
    delta = x - xp0
    epsilon = float(np.spacing(np.finfo(_NUMPY_DTYPE[xp.dtype]).eps))
    dx0 = dx.abs() <= epsilon
    f = torch.where(dx0, fp0, fp0 + (delta / torch.where(dx0, torch.ones_like(dx), dx)) * df)
    # `left` / `right` as Python scalars: a CPU tensor would be copied to the
    # device, which a CUDA graph cannot capture
    f = torch.where(x < xp[..., :1], fp[..., :1] if left is None else float(left), f)
    f = torch.where(x > xp[..., -1:], fp[..., -1:] if right is None else float(right), f)
    return f

