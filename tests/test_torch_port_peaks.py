"""The port's batched peak finder (swinwnet_tpu_torch/physics/peaks.py)
against the JAX package's `find_peaks_device_batch`, on the same numpy
spectra, on the CPU: Gaussian peaks on the 1241-bin grid, with noise, with
plateaus, with the equal-height ties of tests/test_physics_device.py, and
empty spectra. The tables' `valid` and `idx` are equal; widths, heights and
prominences agree to rtol 1e-5 (the same fp32 arithmetic, observed equal)."""

import numpy as np
import pytest
import torch

from swinwnet_tpu.physics.peaks import find_peaks_device_batch as jax_find_peaks
from swinwnet_tpu_torch.physics.peaks import MAX_PEAKS, _enforce_distance, find_peaks_device

torch.set_num_threads(1)

N_HR = 1241


def synth_spectrum(rng, n, n_peaks=8):
    x = np.linspace(0, 7.5, n)
    I = np.zeros(n)
    for _ in range(n_peaks):
        I += rng.uniform(0.3, 5.0) * np.exp(-0.5 * ((x - rng.uniform(0.3, 7.0)) / rng.uniform(0.03, 0.12)) ** 2)
    return I.astype(np.float32)


def spectra(seed):
    rng = np.random.default_rng(seed)
    clean = [synth_spectrum(rng, N_HR) for _ in range(2)]
    noisy = synth_spectrum(rng, N_HR) + rng.uniform(0, 0.3, N_HR).astype(np.float32)
    steps = np.round(synth_spectrum(rng, N_HR, 12) * 4) / 4  # plateaus and exact ties
    flat = clean[0].copy()
    flat[400:430] = flat[400:430].max() + 1.0  # a long plateau
    return np.stack(clean + [noisy, steps, flat, np.zeros(N_HR, np.float32)]).astype(np.float32)


def assert_tables_equal(got, want):
    assert set(got) == set(want)
    np.testing.assert_array_equal(got["valid"].numpy(), np.asarray(want["valid"]))
    np.testing.assert_array_equal(got["idx"].numpy(), np.asarray(want["idx"]))
    assert got["idx"].dtype == torch.int32
    for key in ("widths", "heights", "prominences"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), rtol=1e-5, atol=0, err_msg=key)


@pytest.mark.parametrize("seed", range(3))
def test_matches_jax_on_seeded_spectra(seed):
    S = spectra(seed)
    want = jax_find_peaks(S)
    got = find_peaks_device(torch.from_numpy(S))
    assert got["valid"].shape == (len(S), MAX_PEAKS)
    assert int(got["valid"].sum()) > 10  # not vacuous
    assert not got["valid"][-1].any()  # the empty spectrum has no peaks
    assert_tables_equal(got, want)


@pytest.mark.parametrize("gates", [dict(height=0.0, distance=10, prominence=0.0, width=0),
                                   dict(height=0.0, distance=1, prominence=0.0, width=0),
                                   dict(height=1.0, distance=25, prominence=0.5, width=8)])
def test_gates_and_ties_match_jax(gates):
    """The tie cases of test_physics_device.py::test_distance_gate_ties_match_scipy
    (two, three and twenty equal heights within `distance`; the later
    position wins), a plateau, and other gate settings."""
    two = np.zeros(500, np.float32)
    two[[10, 15]] = 5.0
    two[30] = 2.0
    three = np.zeros(500, np.float32)
    three[[10, 17, 24]] = 5.0
    twenty = np.zeros(500, np.float32)
    twenty[np.arange(10, 10 + 20 * 9, 9)] = 5.0
    plateau = np.zeros(500, np.float32)
    plateau[[1, 2, 3, 4, 5, 8, 40]] = [1, 5, 5, 5, 1, 3, 2]
    S = np.stack([two, three, twenty, plateau, synth_spectrum(np.random.default_rng(9), 500)])
    assert_tables_equal(find_peaks_device(torch.from_numpy(S), **gates), jax_find_peaks(S, **gates))


def test_one_spectrum_and_a_short_one():
    S = spectra(4)
    one = find_peaks_device(torch.from_numpy(S[0]))
    assert one["valid"].shape == (MAX_PEAKS,)
    batch = find_peaks_device(torch.from_numpy(S))
    for key in one:
        np.testing.assert_array_equal(one[key].numpy(), batch[key][0].numpy())
    short = S[:, :50]  # fewer samples than table slots: n columns, as in JAX
    got = find_peaks_device(torch.from_numpy(short), height=0.0, prominence=0.0, width=0)
    assert got["valid"].shape == (len(S), 50)
    assert_tables_equal(got, jax_find_peaks(short, height=0.0, prominence=0.0, width=0))


def test_distance_gate_loops_over_candidate_ranks_only(monkeypatch):
    """The gate reads the largest candidate count once and loops that often:
    a batch with k candidates at most takes k rounds, whatever n is."""
    mask = torch.zeros(3, 1000, dtype=torch.bool)
    mask[0, [100, 105, 300]] = True
    mask[1, [7, 8]] = True
    I = torch.rand(3, 1000)
    calls = []
    real = torch.Tensor.scatter_
    monkeypatch.setattr(torch.Tensor, "scatter_", lambda *a, **k: calls.append(1) or real(*a, **k))
    keep = _enforce_distance(mask, I, 10)
    assert len(calls) == 3  # one write of the keep mask a rank
    hi = 100 if I[0, 100] > I[0, 105] else 105  # a tie goes to the later position
    assert keep[0].nonzero().flatten().tolist() == [hi, 300]
    assert keep[1].sum() == 1 and not keep[2].any()
