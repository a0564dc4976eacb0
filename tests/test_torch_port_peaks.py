"""The port's batched peak finder (swinwnet_tpu_torch/physics/peaks.py)
against the JAX package's `find_peaks_device_batch`, on the same numpy
spectra, on the CPU: Gaussian peaks on the 1241-bin grid, with noise, with
plateaus, with the equal-height ties of tests/test_physics_device.py, and
empty spectra, and spectra with the most candidates a length-n spectrum can
hold, (n - 1) // 2, the distance gate's static loop count. The tables'
`valid` and `idx` are equal; widths, heights and prominences agree to rtol
1e-5 (the same fp32 arithmetic, observed equal)."""

import numpy as np
import pytest
import torch

from swinwnet_tpu.physics.peaks import find_peaks_device_batch as jax_find_peaks
from swinwnet_tpu_torch.physics.peaks import (
    MAX_PEAKS,
    _enforce_distance,
    _local_maxima_mask,
    find_peaks_device,
    max_candidates,
)

torch.set_num_threads(1)

N_HR = 1241
HOST_READS = ("item", "__int__", "__float__", "__bool__", "tolist", "numpy")


def refuse(name):
    def read(*_, **__):
        raise AssertionError(f"a host read: Tensor.{name}")
    return read


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
    """The gate loops over the most candidates a length-n spectrum can hold,
    (n - 1) // 2 ranks, whatever the mask: one count update a rank, and no
    read from the device, so a CUDA graph that captured it on one batch
    gives the right peaks on any other."""
    mask = torch.zeros(3, 1000, dtype=torch.bool)
    mask[0, [100, 105, 300]] = True
    mask[1, [7, 8]] = True
    I = torch.rand(3, 1000)
    calls = []
    real = torch.Tensor.addcmul_
    monkeypatch.setattr(torch.Tensor, "addcmul_", lambda *a, **k: calls.append(1) or real(*a, **k))
    for name in HOST_READS:
        monkeypatch.setattr(torch.Tensor, name, refuse(name))
    keep = _enforce_distance(mask, I, 10)
    monkeypatch.undo()
    assert len(calls) == max_candidates(1000) == 499  # one update of the counts a rank
    hi = 100 if I[0, 100] > I[0, 105] else 105  # a tie goes to the later position
    assert keep[0].nonzero().flatten().tolist() == [hi, 300]
    assert keep[1].sum() == 1 and not keep[2].any()


def alternating(n, seed):
    """A spectrum with a local maximum at every odd position short of the
    last sample: (n - 1) // 2 of them, the most a length-n spectrum holds;
    heights drawn from `seed` (with ties), zeros between."""
    I = np.zeros(n, np.float32)
    odd = np.arange(1, n - 1, 2)
    I[odd] = np.round(np.random.default_rng(seed).uniform(0.2, 5.0, len(odd)), 1)
    return I


@pytest.mark.parametrize("n", [160, 831, 832, 1240, 1241])
def test_bound_reaching_spectra_match_jax(n):
    """Spectra with (n - 1) // 2 candidates, n odd and even, through the
    distance gate at 1 (every candidate kept), 10 and 25, against JAX."""
    S = np.stack([alternating(n, seed) for seed in range(3)])
    assert int(_local_maxima_mask(torch.from_numpy(S)).sum(1).max()) == max_candidates(n)
    for distance in (1, 10, 25):
        gates = dict(height=0.0, distance=distance, prominence=0.0, width=0)
        got = find_peaks_device(torch.from_numpy(S), **gates)
        assert_tables_equal(got, jax_find_peaks(S, **gates))
        if distance == 1:
            assert bool(got["valid"].all())  # more peaks than table slots: every slot filled


def test_a_batch_of_many_candidates_and_none_matches_jax():
    """One spectrum at the bound, one with none (flat), one with a few
    peaks and one all zeros in one batch: each row's peaks are those it has
    alone, and those of JAX."""
    rng = np.random.default_rng(7)
    S = np.stack([alternating(N_HR, 5), np.full(N_HR, 3.0, np.float32), synth_spectrum(rng, N_HR),
                  np.zeros(N_HR, np.float32)])
    for gates in (dict(height=0.0, distance=10, prominence=0.0, width=0), {}):
        got = find_peaks_device(torch.from_numpy(S), **gates)
        assert_tables_equal(got, jax_find_peaks(S, **gates))
        assert not got["valid"][1].any() and not got["valid"][3].any()
        for row in range(len(S)):
            alone = find_peaks_device(torch.from_numpy(S[row:row + 1]), **gates)
            for key in got:
                np.testing.assert_array_equal(got[key][row].numpy(), alone[key][0].numpy())
    assert int(got["valid"][2].sum()) > 2
