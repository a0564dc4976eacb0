"""Golden-baseline regression comparison against the published results JSONs
(a copy of `swinwnet_tpu/evalharness/regression.py`; numpy only).

The reference's de-facto regression test is comparing a fresh run's metric
mean/std with the per-sample arrays frozen in `results/*.json` (SURVEY.md §4).
`compare_with_baseline` formalizes that: load a published file, compute
mean/std, and check a new run's statistics fall within a tolerance band.
"""

from __future__ import annotations

import json
from typing import Dict, Sequence, Union

import numpy as np

# Published headline statistics (mean, std) distilled from results/*.json
# (SURVEY.md §6). Used when the JSON files themselves are not on disk.
PUBLISHED = {
    "SwinUnet_pretrain_segmentation_metrics": {
        "IoU@0.50": (0.7970, 0.1450),
        "Dice@0.50": (0.8771, 0.1261),
        "PixelAccuracy@0.50": (0.9680, 0.0302),
    },
    "SwinWNet_diffraction+error_matrix_segmentation_metrics": {
        "IoU@0.50": (0.7842, 0.0706),
        "Dice@0.50": (0.8770, 0.0513),
    },
    "SwinWNet_diffraction+error_matrix_upscaling_metrics": {
        "PSNR": (31.234, 2.686),
        "SSIM": (0.9643, 0.0149),
    },
    "SwinWnet_diffraction+error_matrix_physycal_metrics_extended": {
        "Integral Intensity": (1.980, 5.403),
        "Peak Intensity": (5.865, 14.20),
        "Shape": (0.0335, 0.0184),
    },
}


def load_baseline_arrays(path: str) -> Dict[str, np.ndarray]:
    """Flatten a published results JSON into named float arrays.

    Handles the three schemas: per-sample metric dicts (metrics_25/50/75),
    plain float lists (PSNRs/SSIMs/peak_losses), and the physical-metric
    lists ('Integral Intensity losses' etc.)."""
    with open(path) as f:
        payload = json.load(f)
    out: Dict[str, np.ndarray] = {}
    for key, value in payload.items():
        if not isinstance(value, list) or not value:
            continue
        if isinstance(value[0], dict):
            for metric in value[0]:
                out[f"{key}/{metric}"] = np.array([row[metric] for row in value], float)
        else:
            out[key] = np.asarray(value, float)
    return out


def compare_with_baseline(
    new_values: Union[Sequence[float], np.ndarray],
    baseline_values: Union[Sequence[float], np.ndarray],
    rel_tol: float = 0.05,
    std_slack: float = 0.5,
) -> Dict[str, float]:
    """Compare mean/std of a fresh metric distribution with a frozen baseline.

    Passes when |mean_new - mean_base| <= rel_tol * |mean_base| +
    std_slack * sem_base. Returns the comparison record (with 'pass' flag)."""
    new = np.asarray(new_values, float)
    base = np.asarray(baseline_values, float)
    mean_new, mean_base = float(new.mean()), float(base.mean())
    sem = float(base.std(ddof=1) / np.sqrt(len(base))) if len(base) > 1 else 0.0
    tol = rel_tol * abs(mean_base) + std_slack * sem
    return {
        "mean_new": mean_new,
        "mean_baseline": mean_base,
        "tolerance": tol,
        "delta": mean_new - mean_base,
        "pass": abs(mean_new - mean_base) <= tol,
    }
