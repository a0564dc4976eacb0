"""Headless labeling core (a copy of `swinwnet_tpu/apps/labeler.py`, host
numpy; reference: DiffractionLabeler/diffraction_labeling_gui/
diff_labeling_gui.py).

The GUI's physics is separable from Qt: peaks are labeled as intervals
[a, b] on the 1D I(d) profile and projected back to 2D masks through the
detector's d-map `d(lambda, theta)` (reference :112-126 for the map,
:502-528 for the interval -> mask union). These functions are that core;
the optional Qt shell (apps/gui.py) builds on them.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..core.config import GEOMETRY


def compute_d_map(
    theta_range: Tuple[float, float] = GEOMETRY.theta_range,
    lambda_range: Tuple[float, float] = GEOMETRY.lambda_range,
    H: int = GEOMETRY.height,
    W: int = GEOMETRY.width,
) -> np.ndarray:
    """Interplanar-distance map of the detector; NaN where undefined
    (theta = 0 column). Matches diff_labeling_gui.py:112-126."""
    theta_vals = np.linspace(theta_range[0], theta_range[1], W, dtype=np.float32)
    lam_vals = np.linspace(lambda_range[0], lambda_range[1], H, dtype=np.float32)
    theta_rad = np.deg2rad(np.abs(theta_vals)).astype(np.float32)
    Lam, Theta = np.meshgrid(lam_vals, theta_rad, indexing="ij")
    with np.errstate(divide="ignore", invalid="ignore"):
        d = Lam / (2.0 * np.sin(Theta / 2.0))
    d[~np.isfinite(d)] = np.nan
    return d


def make_fixed_centers(d_min: float, d_max: float, n: int) -> np.ndarray:
    return np.linspace(d_min, d_max, int(n)).astype(np.float32)


def intervals_to_mask(
    intervals: Sequence[Tuple[float, float]],
    d_map: Optional[np.ndarray] = None,
    base_mask: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Union of d-intervals projected to a 2D uint8 mask, OR-ed with an
    optional base mask (diff_labeling_gui.py:502-528)."""
    if d_map is None:
        d_map = compute_d_map()
    H, W = d_map.shape
    base = (
        base_mask.astype(bool)
        if base_mask is not None
        else np.zeros((H, W), dtype=bool)
    )
    interval_mask = np.zeros((H, W), dtype=bool)
    for a, b in intervals:
        with np.errstate(invalid="ignore"):
            interval_mask |= (d_map >= a) & (d_map <= b)
    return (base | interval_mask).astype(np.uint8)


def save_labels(path: str, masks: np.ndarray, indices: Optional[np.ndarray] = None):
    """Save masks (+ labeled indices) like the GUI's export
    (diff_labeling_gui.py:413-429)."""
    np.save(path, {"masks": masks.astype(np.uint8), "indices": indices})


def label_batch(
    diffractions: np.ndarray,
    intervals_per_image: List[Sequence[Tuple[float, float]]],
    theta_range=GEOMETRY.theta_range,
    lambda_range=GEOMETRY.lambda_range,
) -> np.ndarray:
    """Project per-image interval lists into a [N, H, W] uint8 mask stack."""
    N, H, W = diffractions.shape
    d_map = compute_d_map(theta_range, lambda_range, H, W)
    return np.stack(
        [intervals_to_mask(iv, d_map) for iv in intervals_per_image]
    )
