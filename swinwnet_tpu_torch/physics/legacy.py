"""Legacy/support physics APIs (port of `swinwnet_tpu/physics/legacy.py`;
reference: support_files/Peak_loss.py, support_files/DiffQ.py).

`DiffractionPipeline` is the older *scalar* peak-matching loss: batch-summed
squared log-intensity error over matched peaks (matching on the peak's d
position, not its center of mass; no shape/max-intensity terms —
Peak_loss.py:128-190). It produced the published
`results/SwinWnet_physycal_loss_RL.json` / `AGVpool_peak_losses.json` scalars.

`naive_rebin` is the DiffQ-style per-pixel rebinner
(support_files/DiffQ.py:13-83), implemented as a genuinely *independent*
oracle: a scalar-math double loop over detector pixels with bisect-based bin
lookup, sharing no code with the vectorized `Qwrapper` it cross-checks.
"""

from __future__ import annotations

import math

import numpy as np

from ..core.config import GEOMETRY
from .peaks import find_peaks_for_batch
from .qwrapper import Qwrapper


def scalar_peak_matching_loss(batch_pred, batch_true, tol: float = 0.05) -> float:
    """Batch-summed (log(I1+1) - log(I2+1))^2 over d-matched peaks
    (Peak_loss.py:128-154)."""
    total = 0.0
    for pred_peaks, true_peaks in zip(batch_pred, batch_true):
        if not pred_peaks or not true_peaks:
            continue
        for p1 in pred_peaks:
            d1, I1 = p1["d"], p1["integral_intensity"]
            p2 = min(true_peaks, key=lambda p: abs(p["d"] - d1))
            if abs(d1 - p2["d"]) <= tol:
                total += (
                    math.log(max(I1, 0) + 1) - math.log(max(p2["integral_intensity"], 0) + 1)
                ) ** 2
    return float(total)


class DiffractionPipeline:
    """Reference-compatible scalar-loss facade (Peak_loss.py:161-190). The
    rebin runs on the batch's device (numpy batches on `device`; None: the
    card), the peaks and matching on the host."""

    def __init__(
        self,
        fixed_centers_pred,
        fixed_centers_true,
        theta_range=GEOMETRY.theta_range,
        L_range=GEOMETRY.lambda_range,
        device=None,
    ):
        self.qw_pred = Qwrapper(theta_range, L_range, fixed_centers_pred, device=device)
        self.qw_true = Qwrapper(theta_range, L_range, fixed_centers_true, device=device)

    def __call__(
        self,
        batch_pred_2d,
        batch_true_2d,
        peak_params_pred=None,
        peak_params_true=None,
        tol: float = 0.05,
    ) -> float:
        pred_DI = self.qw_pred.tensor_to_d(batch_pred_2d)
        true_DI = self.qw_true.tensor_to_d(batch_true_2d)
        pred_peaks = find_peaks_for_batch(pred_DI, **(peak_params_pred or {}))
        true_peaks = find_peaks_for_batch(true_DI, **(peak_params_true or {}))
        return scalar_peak_matching_loss(pred_peaks, true_peaks, tol)


def naive_rebin(image: np.ndarray, centers, theta_range=GEOMETRY.theta_range,
                L_range=GEOMETRY.lambda_range, d_max: float = GEOMETRY.d_max) -> np.ndarray:
    """DiffQ-style single-image rebin -> I(d) (support_files/DiffQ.py:13-83).

    Independent oracle for `Qwrapper.rebin`: pure scalar math per pixel
    (d = lambda / (2 sin(|theta|/2)), bisect bin lookup over float32 edges,
    d > d_max dropped). Deliberately loop-based and free of any shared helper
    so a bug in the vectorized path cannot hide here.
    """
    from bisect import bisect_right

    image = np.asarray(image, dtype=np.float64)
    if image.ndim != 2:
        raise ValueError("naive_rebin expects a single [H, W] image")
    H, W = image.shape

    centers = [float(np.float32(c)) for c in np.asarray(centers)]
    n = len(centers)
    # edges from centers, in float32 arithmetic like the reference's buffers
    f32 = np.float32
    edges = [float(f32(f32(centers[0]) - f32(f32(centers[1]) - f32(centers[0])) * f32(0.5)))]
    for a, b in zip(centers[:-1], centers[1:]):
        edges.append(float(f32((a + b)) * 0.5))  # exact: f64 sum of f32s rounds like f32 add
    edges.append(float(f32(f32(centers[-1]) + f32(f32(centers[-1]) - f32(centers[-2])) * f32(0.5))))

    out = [0.0] * n
    th_lo, th_hi = theta_range
    lam_lo, lam_hi = L_range
    for i in range(H):
        lam = lam_lo + (lam_hi - lam_lo) * i / (H - 1)
        for j in range(W):
            theta_deg = th_lo + (th_hi - th_lo) * j / (W - 1)
            theta = math.radians(abs(theta_deg))
            s = 2.0 * math.sin(theta / 2.0)
            # theta == 0 (odd-W grids) => d = inf, dropped by the d_max mask
            # exactly like the vectorized path's divide-by-zero -> inf
            if s == 0.0:
                continue
            d = lam / s
            if d > d_max:
                continue
            b = bisect_right(edges, d) - 1
            if b < 0:
                b = 0
            elif b > n - 1:
                b = n - 1
            out[b] += image[i, j]
    return np.asarray(out, dtype=np.float64)
