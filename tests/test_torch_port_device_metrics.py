"""The port's on-device d-space metrics (swinwnet_tpu_torch/physics:
device_metrics.py, emd.py) against the JAX package's, on the same numpy
spectra, on the CPU.

Tolerances: `interp` against `jnp.interp` 1e-6 absolute on values of
order 1 (the two evaluate the same formula; XLA may fuse its multiply-add,
observed 6e-8); the metrics rtol 1e-4 and atol 1e-5, where the window sums
over up to 512 samples run in other orders (observed 1e-6 of the largest
value)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swinwnet_tpu.physics import d_centers_hr, d_centers_lr, find_peaks_for_batch, peak_matching_loss
from swinwnet_tpu.physics.device_metrics import diffraction_metrics_device as jax_metrics
from swinwnet_tpu_torch.physics.device_metrics import diffraction_metrics_device
from swinwnet_tpu_torch.physics.emd import interp

torch.set_num_threads(1)

KEYS = ("Integral Intensity", "Peak Intensity", "Shape")


def synth_spectrum(rng, n, n_peaks=8):
    x = np.linspace(0, 7.5, n)
    I = np.zeros(n)
    for _ in range(n_peaks):
        I += rng.uniform(0.3, 5.0) * np.exp(-0.5 * ((x - rng.uniform(0.3, 7.0)) / rng.uniform(0.03, 0.12)) ** 2)
    return I.astype(np.float32)


def pairs(seed, n=len(d_centers_hr), B=3):
    """test_physics_device.py's pairs: true = scaled pred plus two weak peaks."""
    rng = np.random.default_rng(seed)
    pred = np.stack([synth_spectrum(rng, n) for _ in range(B)])
    true = pred * rng.uniform(0.7, 1.3, size=(B, 1)).astype(np.float32)
    true += np.stack([synth_spectrum(rng, n, n_peaks=2) * 0.3 for _ in range(B)])
    return pred, true


def assert_metrics_close(got, want):
    for key in KEYS:
        assert got[key].shape == np.asarray(want[key]).shape
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), rtol=1e-4, atol=1e-5, err_msg=key)


def test_interp_matches_jnp_interp_with_sentinels():
    rng = np.random.default_rng(0)
    for trial in range(6):
        xp = np.sort(rng.uniform(-0.05, 0.05, 40)).astype(np.float32)
        xp[-(trial + 3):] = 1e9  # masked samples: repeated 1e9 sentinels
        xp[5] = xp[6]  # a zero-width interval
        fp = rng.uniform(0, 1, 40).astype(np.float32)
        x = np.linspace(-0.06, 0.06, 64).astype(np.float32)
        for left, right in ((0.0, 0.0), (None, None), (-1.0, 2.0)):
            want = np.asarray(jnp.interp(x, xp, fp, left=left, right=right))
            got = interp(torch.from_numpy(x), torch.from_numpy(xp), torch.from_numpy(fp), left, right)
            np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    # batched over leading axes, each row with its own xp
    xp = np.sort(rng.uniform(-1, 1, (2, 3, 17)), axis=-1).astype(np.float32)
    fp = rng.uniform(0, 1, (2, 3, 17)).astype(np.float32)
    x = rng.uniform(-1.2, 1.2, (2, 3, 9)).astype(np.float32)
    got = interp(*map(torch.from_numpy, (x, xp, fp)), 0.0, 0.0).numpy()
    for i in range(2):
        for j in range(3):
            want = np.asarray(jnp.interp(x[i, j], xp[i, j], fp[i, j], left=0.0, right=0.0))
            np.testing.assert_allclose(got[i, j], want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("seed", range(4))
def test_metrics_match_jax(seed):
    pred, true = pairs(seed)
    want = jax_metrics(pred, true, d_centers_hr)
    got = diffraction_metrics_device(torch.from_numpy(pred), torch.from_numpy(true), d_centers_hr)
    assert got["Integral Intensity"].device.type == "cpu"
    assert np.all(np.asarray(want["Integral Intensity"]) > 0)  # matched peaks: not vacuous
    assert_metrics_close(got, want)


def test_scaled_metrics_match_jax():
    pred, true = pairs(7, n=len(d_centers_lr), B=2)
    want = jax_metrics(pred * 4, true, d_centers_lr, scale_pred=True)
    got = diffraction_metrics_device(pred * 4, true, d_centers_lr, scale_pred=True, device="cpu")
    assert_metrics_close(got, want)


def test_identical_and_empty_spectra_give_zero():
    pred, _ = pairs(42, B=2)
    same = diffraction_metrics_device(torch.from_numpy(pred), torch.from_numpy(pred), d_centers_hr)
    zeros = torch.zeros(2, len(d_centers_hr))
    empty = diffraction_metrics_device(zeros, zeros, d_centers_hr)
    for key in KEYS:
        np.testing.assert_allclose(same[key].numpy(), 0, atol=1e-6, err_msg=key)
        np.testing.assert_array_equal(empty[key].numpy(), 0)


def test_w_max_truncation_matches_jax_and_host():
    """test_physics_device.py's ultra-wide peak (fitted width ~212 samples,
    host window ~318 > 256): the default cap truncates it as JAX does, and a
    wide enough cap matches the host scipy pipeline."""
    n = len(d_centers_lr)
    x = np.arange(n, dtype=np.float32)
    wide = 10.0 * np.exp(-0.5 * ((x - 400) / 90.0) ** 2)
    narrow = 6.0 * np.exp(-0.5 * ((x - 120) / 4.0) ** 2)
    base = (wide + narrow + 0.2).astype(np.float32)
    true, pred = base[None], (base * 1.25)[None]
    for w_max in (256, 416):
        got = diffraction_metrics_device(torch.from_numpy(pred), torch.from_numpy(true), d_centers_lr, w_max=w_max)
        assert_metrics_close(got, jax_metrics(pred, true, d_centers_lr, w_max=w_max))
    host = peak_matching_loss(find_peaks_for_batch([{"d": d_centers_lr, "I": pred[0]}]),
                              find_peaks_for_batch([{"d": d_centers_lr, "I": true[0]}]))
    np.testing.assert_allclose(got["Integral Intensity"].numpy(), host["Integral Intensity"], rtol=1e-4, atol=1e-6)
