"""Input preparation and piecewise log normalization (port of
`swinwnet_tpu/ops/norms.py`).

`normalize_piecewise` min-max scales each image, then applies log1p above a
threshold; `denormalize_piecewise` is its exact inverse given the saved
params.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch


def ensure_2ch(x: torch.Tensor) -> torch.Tensor:
    """[B,1,H,W] -> [B,2,H,W] by adding the Poisson error channel
    err = sqrt(|I|)."""
    if x.shape[1] == 2:
        return x
    return torch.cat([x, torch.sqrt(torch.abs(x))], dim=1)


def normalize_piecewise(
    x: torch.Tensor, threshold: float = 0.01, eps: float = 1e-6
) -> Tuple[torch.Tensor, Dict[str, object]]:
    """Per-image min-max to [0,1], log1p where above threshold."""
    x_min = torch.amin(x, dim=(2, 3), keepdim=True)
    x_max = torch.amax(x, dim=(2, 3), keepdim=True)
    x01 = (x - x_min) / (x_max - x_min + eps)
    x_norm = torch.where(x01 > threshold, torch.log1p(x01), x01)
    return x_norm, {"x_min": x_min, "x_max": x_max, "threshold": threshold}


def denormalize_piecewise(
    x_norm: torch.Tensor, params: Dict[str, object], eps: float = 1e-6
) -> torch.Tensor:
    """Inverse of `normalize_piecewise`."""
    x_min, x_max = params["x_min"], params["x_max"]
    x01 = torch.where(x_norm > params["threshold"], torch.expm1(x_norm), x_norm)
    return x01 * (x_max - x_min + eps) + x_min
