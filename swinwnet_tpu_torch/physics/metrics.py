"""High-level physical metrics facade (port of
`swinwnet_tpu/physics/metrics.py`; reference: Diffraction_metrics.py:277-306).

The d-space rebinning runs on the device (`Qwrapper.rebin`); the sequential
scipy peak finding and greedy matching of the published specification run
on the host over the rebinned spectra, as in the JAX package: the
`[B, n_bins]` spectra are a few hundred KB.
"""

from __future__ import annotations

from ..core.config import GEOMETRY
from .host_oracle import peak_matching_loss
from .peaks import find_peaks_for_batch
from .qwrapper import Qwrapper


class DiffractionMetricsCalculator:
    """Compare predicted and true 2D patterns in d-space.

    Returns ``{"Integral Intensity", "Peak Intensity", "Shape"}`` per-sample
    lists, the reference calculator's schema. Tensors are rebinned on their
    own device, numpy batches on `device` (None: the card)."""

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
        tol=0.05,
    ):
        pred_DI = self.qw_pred.tensor_to_d(batch_pred_2d)
        true_DI = self.qw_true.tensor_to_d(batch_true_2d)
        pred_peaks = find_peaks_for_batch(pred_DI, **(peak_params_pred or {}))
        true_peaks = find_peaks_for_batch(true_DI, **(peak_params_true or {}))
        return peak_matching_loss(pred_peaks, true_peaks, tol)
