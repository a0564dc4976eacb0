"""Host-side transcription of the published d-space peak-metric
specification (a copy of `swinwnet_tpu/physics/host_oracle.py`: numpy and
scipy only; the port keeps its own copy because it imports nothing of the
JAX package).

These functions follow the reference's Diffraction_metrics.py:76-271
bit for bit: the window truncation ``int(1.5 * width)``, the greedy
first-minimum matching order, the ``(log(I+1))^2`` intensity form, and the
64-point relative resampling grid all decide the published baselines. This
module is the oracle the on-device versions (``peaks.find_peaks_device``,
``device_metrics.diffraction_metrics_device``) are held against.

Spec, in words:

* **Peak tables** — ``scipy.signal.find_peaks`` with gates height=0.05,
  distance=10, prominence=0.1, width=5 (Diffraction_metrics.py:109-118). Each
  detected peak carries its grid d, intensity-weighted center-of-mass d, the
  integral and max intensity, and the raw profile over a half-window of
  ``int(1.5 * fitted_width)`` samples, clipped to the spectrum
  (Diffraction_metrics.py:76-93,122-140). ``scale=True`` divides I by 4 to
  undo the 4x pixel count of the 2x-super-resolved pattern (:110).
* **Shape distance** — profiles are normalized to unit mass, resampled onto
  the relative grid ``x = (d - d_peak)/d_peak`` over ``linspace(-.03,.03,64)``
  and compared by W1 = sum |CDF_p - CDF_q| * dx (:150-203).
* **Matching** — every predicted peak greedily takes the true peak nearest in
  d (keyed on the *pred center-of-mass* vs the *true grid d*, gated at
  tol=0.05 A on the two centers-of-mass); matched pairs accumulate squared
  log1p-intensity errors plus the shape W1, summed per sample (:209-271).
"""

from __future__ import annotations

import numpy as np
from scipy.signal import find_peaks

X_REF = np.linspace(-0.03, 0.03, 64)

# scipy.find_peaks gate defaults published with the baselines
# (Diffraction_metrics.py:109-118)
GATES = dict(height=0.05, distance=10, prominence=0.1, width=5)


# ---------------------------------------------------------------------------
# Peak tables
# ---------------------------------------------------------------------------


def _peak_record(d, I, center, half_window):
    """Record for one detected peak: window of `half_window` samples each side
    of `center` (end-exclusive on the right, per the spec's slice form)."""
    lo = max(center - half_window, 0)
    hi = min(center + half_window, len(d))
    seg_d, seg_I = d[lo:hi], I[lo:hi]
    mass = np.sum(seg_I)
    return {
        "d": float(d[center]),
        "d_com": float(np.sum(seg_d * seg_I) / mass),
        "integral_intensity": float(mass),
        "max_intensity": float(I[center]),
        "profile_d": seg_d,
        "profile_I": seg_I,
    }


def extract_peak_region(d, I, peak_idx, peaks, properties, scale_factor=1.5, default_window=15):
    """Profile window around one peak (spec: Diffraction_metrics.py:76-93).

    Kept for API compatibility; `find_peaks_for_batch` uses the same slice
    arithmetic via `_peak_record`.
    """
    hits = np.flatnonzero(np.asarray(peaks) == peak_idx)
    if hits.size == 0:
        return d[peak_idx : peak_idx + 1], I[peak_idx : peak_idx + 1]
    if "widths" in properties:
        half = int(properties["widths"][hits[0]] * scale_factor)
    else:
        half = default_window
    lo = max(peak_idx - half, 0)
    hi = min(peak_idx + half, len(d))
    return d[lo:hi], I[lo:hi]


def find_peaks_for_batch(
    batch_DI,
    height=0.05,
    distance=10,
    prominence=0.1,
    width=5,
    scale_factor=1.5,
    default_window=15,
    scale=False,
):
    """Per-sample peak tables from ``Qwrapper.tensor_to_d`` output
    (spec: Diffraction_metrics.py:96-144)."""
    tables = []
    for sample in batch_DI:
        d = np.asarray(sample["d"])
        I = np.asarray(sample["I"]) / 4 if scale else np.asarray(sample["I"])
        centers, props = find_peaks(
            I, height=height, distance=distance, prominence=prominence, width=width
        )
        if "widths" in props:
            halves = (props["widths"] * scale_factor).astype(int)
        else:
            halves = np.full(len(centers), default_window, dtype=int)
        tables.append([_peak_record(d, I, c, h) for c, h in zip(centers, halves)])
    return tables


# ---------------------------------------------------------------------------
# Shape W1 (EMD) on relative profiles
# ---------------------------------------------------------------------------


def normalize_profile(I):
    mass = np.sum(I)
    return None if mass <= 0 else I / mass


def resample_profile(d, I, d_center, x_ref):
    """Unit-mass profile resampled onto the relative grid, 0-filled outside."""
    unit = normalize_profile(I)
    if unit is None:
        return None
    return np.interp(x_ref, (d - d_center) / d_center, unit, left=0.0, right=0.0)


def emd_1d(p, q, dx):
    return np.sum(np.abs(np.cumsum(p) - np.cumsum(q))) * dx


def emd_shape_loss(peak1, peak2, x_ref=X_REF, eps=1e-12):
    """W1 between two peaks' relative profiles (spec: :150-203).
    Degenerate (zero-mass) profiles contribute 0."""
    curves = []
    for pk in (peak1, peak2):
        c = resample_profile(pk["profile_d"], pk["profile_I"], pk["d"], x_ref)
        if c is None:
            return 0.0
        c = np.maximum(c, 0)
        curves.append(c / (np.sum(c) + eps))
    return emd_1d(curves[0], curves[1], x_ref[1] - x_ref[0])


# ---------------------------------------------------------------------------
# Greedy matching + per-sample aggregation
# ---------------------------------------------------------------------------


def _log1p_sq_err(a, b):
    return (np.log(max(a, 0) + 1) - np.log(max(b, 0) + 1)) ** 2


def compare_peak_sets(pred_peaks, true_peaks, tol=0.05):
    """Per-sample (integral, max, shape) totals over matched peaks
    (spec: :209-248). Matching key: pred d_com vs true grid d; gate: the two
    centers-of-mass within `tol`. np.argmin keeps the spec's first-minimum
    tie behavior."""
    if not pred_peaks or not true_peaks:
        return 0.0, 0.0, 0.0

    true_d = np.array([p["d"] for p in true_peaks])
    tot_int = tot_max = tot_shape = 0.0
    for pk in pred_peaks:
        mate = true_peaks[int(np.argmin(np.abs(true_d - pk["d_com"])))]
        if abs(pk["d_com"] - mate["d_com"]) > tol:
            continue
        tot_int += _log1p_sq_err(pk["integral_intensity"], mate["integral_intensity"])
        tot_max += _log1p_sq_err(pk["max_intensity"], mate["max_intensity"])
        tot_shape += emd_shape_loss(pk, mate, X_REF)
    return tot_int, tot_max, tot_shape


def peak_matching_loss(batch_pred, batch_true, tol=0.05):
    """Batch aggregation into the published metric-dict schema (spec: :251-271)."""
    per_sample = [compare_peak_sets(p, t, tol) for p, t in zip(batch_pred, batch_true)]
    return {
        "Integral Intensity": [s[0] for s in per_sample],
        "Peak Intensity": [s[1] for s in per_sample],
        "Shape": [s[2] for s in per_sample],
    }
