"""The eval harness (swinwnet_tpu_torch/evalharness/harness.py,
regression.py) against the JAX package's, with the reference norm
convention: `MetricsCalculator` on the tiny SwinWNet (embed 12, depths
1-1-1-1, heads 3-6-12-24, window 5) with the same weights (JAX params
carried over), over 2 batches of 2 [40, 40] patterns and masks from
`synthesize_dataset`.

Tolerances: the schema is equal; the segmentation scores are equal (ratios
of exact counts; a pixel's probability would have to sit within ~3e-7 of a
threshold to flip); PSNR within 1e-4 dB and SSIM within 1e-5 (the SR
outputs differ by ~1e-5 relative, see tests/test_torch_port_split.py); the
physical metrics within 1e-4 relative. With random weights the SR output
has no peak the metric spec accepts, so the physics also runs on
synthesized pattern pairs that have peaks, through both harnesses' own
physics call. The notebook convention and the policy are in
tests/test_torch_port_evalharness_conventions.py."""

import json

import numpy as np
import pytest
import torch

import _torch_port_helpers as h
from swinwnet_tpu.evalharness import MetricsCalculator as JaxMetricsCalculator
from swinwnet_tpu.evalharness import calculate_statistics as jax_statistics
from swinwnet_tpu.evalharness import regression as jax_regression
from swinwnet_tpu_torch.data import synthesize_pattern
from swinwnet_tpu_torch.evalharness import (
    PUBLISHED,
    MetricsCalculator,
    calculate_statistics,
    compare_with_baseline,
    load_baseline_arrays,
    write_results_json,
)

torch.set_num_threads(1)

PHYS_RTOL = 1e-4


@pytest.fixture(scope="module")
def runs():
    jmodel, params, port, jloader, loader = h.harness_setup()
    jcalc = JaxMetricsCalculator(jmodel, params, jloader, verbose=False)
    calc = MetricsCalculator(port, loader, verbose=False)
    out = {}
    for method in ("CalculateSegmentationMetrics", "CalculateUpscalerMetrics", "CalculatePhysycalMetrics"):
        out[method] = (getattr(jcalc, method)(), getattr(calc, method)())
    return out, jcalc, calc


def test_segmentation_metrics_equal_jax(runs):
    want, got = runs[0]["CalculateSegmentationMetrics"]
    assert list(got) == ["Low Res", "High Res"] and set(got) == set(want)
    for res in want:
        assert list(got[res]) == ["0.25 thrashold", "0.50 thrashold", "0.75 thrashold"]
        for t in want[res]:
            assert len(got[res][t]) == 4
            assert got[res][t] == want[res][t], (res, t)


def test_upscaler_metrics_match_jax(runs):
    want, got = runs[0]["CalculateUpscalerMetrics"]
    assert list(got) == list(want)
    for section in want:
        assert list(got[section]) == ["PSNR", "SSIM"]
        assert len(got[section]["PSNR"]) == 4
        np.testing.assert_allclose(got[section]["PSNR"], want[section]["PSNR"], rtol=0, atol=1e-4)
        np.testing.assert_allclose(got[section]["SSIM"], want[section]["SSIM"], rtol=0, atol=1e-5)


def test_physical_metrics_match_jax(runs):
    want, got = runs[0]["CalculatePhysycalMetrics"]
    assert list(got) == ["integral", "peak", "shape"]
    for k in want:
        assert got[k].shape == (4,)
        np.testing.assert_allclose(got[k], want[k], rtol=PHYS_RTOL, atol=1e-12)


def peak_patterns(n=2, H=250, W=480):
    """(images_downscaled [n, 2, H/2, W/2], denorm_sr_out [n, 2, H, W]): the
    same Bragg lines on the LR and the HR grid, in counts, with their error
    channel."""
    rng = np.random.default_rng(11)
    lr, hr = [], []
    for i in range(n):
        d = np.sort(rng.uniform(0.8, 4.0, 5))
        inten = rng.uniform(0.5, 3.0, 5)
        for out, (hh, ww) in ((lr, (H // 2, W // 2)), (hr, (H, W))):
            img = synthesize_pattern(d, inten, H=hh, W=ww, seed=None, background=0.0)
            out.append(np.stack([img, np.sqrt(img)]))
    return np.stack(lr).astype(np.float32), np.stack(hr).astype(np.float32)


def test_physical_metrics_on_patterns_with_peaks_match_jax(runs):
    """Both harnesses' physics call (channel 0, pred on the HR d-grid with
    scale=True, true on the LR grid, tol 0.05) on the same SR-branch
    outputs, synthesized so that their spectra have peaks to match."""
    _, jcalc, calc = runs
    down, up = peak_patterns()
    jcalc._sr_forward = lambda variables, images: (down, None, None, up)
    calc.sr_forward = lambda images: (torch.from_numpy(down), None, None, torch.from_numpy(up))
    jcalc.val_loader = calc.val_loader = [(down, None)]
    want, got = jcalc.CalculatePhysycalMetrics(), calc.CalculatePhysycalMetrics()
    assert all(np.all(got[k] > 0) for k in got), got
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=PHYS_RTOL, atol=0)


def test_results_json_round_trip_and_statistics(runs, tmp_path):
    seg = runs[0]["CalculateSegmentationMetrics"][1]
    sr = runs[0]["CalculateUpscalerMetrics"][1]
    phys = runs[0]["CalculatePhysycalMetrics"][1]
    path = tmp_path / "metrics.json"
    payload = {"metrics_50": seg["Low Res"]["0.50 thrashold"], "PSNRs": sr["Summary Metrics"]["PSNR"],
               "Integral Intensity losses": phys["integral"], "stats": torch.tensor([1.5, 2.5])}
    write_results_json(str(path), payload)
    loaded = json.loads(path.read_text())
    assert loaded["metrics_50"] == seg["Low Res"]["0.50 thrashold"]
    assert loaded["PSNRs"] == sr["Summary Metrics"]["PSNR"]
    assert loaded["Integral Intensity losses"] == phys["integral"].tolist()
    assert loaded["stats"] == [1.5, 2.5]
    arrays = load_baseline_arrays(str(path))
    want = jax_regression.load_baseline_arrays(str(path))
    assert arrays.keys() == want.keys() and "metrics_50/IoU" in arrays
    for k in want:
        np.testing.assert_array_equal(arrays[k], want[k])
    for data in (sr["Summary Metrics"]["PSNR"], [3.0], []):
        np.testing.assert_array_equal(calculate_statistics(data, "x", verbose=False),
                                      jax_statistics(data, "x", verbose=False))


def test_compare_with_baseline_on_published():
    assert PUBLISHED == jax_regression.PUBLISHED
    rng = np.random.default_rng(0)
    for name, metrics in PUBLISHED.items():
        for metric, (mean, std) in metrics.items():
            base = rng.normal(mean, std, 200)
            for new in (rng.normal(mean, std, 50), rng.normal(mean * 1.5 + std, std, 50)):
                got = compare_with_baseline(new, base)
                assert got == jax_regression.compare_with_baseline(new, base), (name, metric)
    base = rng.normal(0.797, 0.145, 500)
    assert compare_with_baseline(base[:250], base)["pass"]
    assert not compare_with_baseline(base[:250] + 0.2, base)["pass"]
