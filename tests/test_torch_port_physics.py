"""The port's d-space physics (swinwnet_tpu_torch/physics: qwrapper, legacy,
metrics) against the JAX package's, on the same numpy inputs, on the CPU.

`Qwrapper.rebin` sums each bin in pixel order, as the JAX package's
`segment_sum` does on the CPU, so the spectra agree to fp32 rounding
(rtol 1e-6); the host-side metrics then see the same spectra and agree to
1e-6 too."""

import numpy as np
import pytest
import torch

from swinwnet_tpu import physics as jphys
from swinwnet_tpu.data.generation import synthesize_pattern
from swinwnet_tpu_torch import physics as tphys

torch.set_num_threads(1)

GRID_160 = np.linspace(0.05, 7.49, 160)


def test_d_grid_and_edges_equal():
    for H, W in ((50, 60), (250, 480), (25, 49)):
        np.testing.assert_array_equal(tphys.make_d_grid(H, W), jphys.make_d_grid(H, W))
    for centers in (tphys.d_centers_hr, tphys.d_centers_lr, GRID_160):
        np.testing.assert_array_equal(tphys.centers_to_edges(centers), jphys.centers_to_edges(centers))
    np.testing.assert_array_equal(tphys.d_centers_hr, jphys.d_centers_hr)
    np.testing.assert_array_equal(tphys.d_centers_lr, jphys.d_centers_lr)


@pytest.mark.parametrize("centers,shape", [(GRID_160, (50, 60)), (tphys.d_centers_hr, (250, 480)),
                                           (GRID_160, (25, 49))])
def test_rebin_matches_jax(centers, shape):
    x = np.random.default_rng(3).uniform(0, 1e3, (3, 1, *shape)).astype(np.float32)
    want = np.asarray(jphys.Qwrapper(fixed_centers=centers).rebin(x))
    qw = tphys.Qwrapper(fixed_centers=centers, device="cpu")
    got = qw.rebin(x)
    assert got.device.type == "cpu" and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)
    # a tensor stays on its own device; [B, H, W] is taken as well
    np.testing.assert_allclose(qw.rebin(torch.from_numpy(x[:, 0])).numpy(), want, rtol=1e-6, atol=0)


def test_rebin_needs_a_card_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tphys.Qwrapper(fixed_centers=GRID_160).rebin(np.ones((1, 1, 10, 12), np.float32))


def test_tensor_to_d_schema():
    img = np.random.default_rng(4).uniform(0, 10, (3, 1, 250, 480)).astype(np.float32)
    got = tphys.Qwrapper(fixed_centers=tphys.d_centers_lr, device="cpu").tensor_to_d(img)
    want = jphys.Qwrapper(fixed_centers=jphys.d_centers_lr).tensor_to_d(img)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert set(g) == {"d", "I"} and isinstance(g["I"], np.ndarray)
        assert g["d"].shape == g["I"].shape == (832,)
        np.testing.assert_array_equal(g["d"], w["d"])
        np.testing.assert_allclose(g["I"], w["I"], rtol=1e-6, atol=0)
    with pytest.raises(ValueError, match="B,1,H,W"):
        tphys.Qwrapper(fixed_centers=GRID_160, device="cpu").tensor_to_d(img[:, 0])


def test_naive_rebin_is_the_copy_and_agrees_with_rebin():
    img = np.random.default_rng(5).uniform(0, 10, (25, 49)).astype(np.float32)
    got = tphys.naive_rebin(img, GRID_160)
    np.testing.assert_array_equal(got, jphys.naive_rebin(img, GRID_160))
    rebinned = tphys.Qwrapper(fixed_centers=GRID_160, device="cpu").rebin(img[None, None])[0]
    np.testing.assert_allclose(rebinned.numpy(), got, rtol=1e-5, atol=1e-3)


def _patterns(n, H, W, seed):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        ds = rng.uniform(0.8, 6.5, 6)
        out.append(synthesize_pattern(ds, rng.uniform(0.3, 2.0, 6), H=H, W=W, seed=seed + i))
    return np.stack(out)[:, None].astype(np.float32)


@pytest.mark.parametrize("cls", ["DiffractionMetricsCalculator", "DiffractionPipeline"])
def test_metric_facades_match_jax(cls):
    true = _patterns(3, 250, 480, seed=10)
    pred = true * np.float32(1.2) + _patterns(3, 250, 480, seed=20) * np.float32(0.2)
    want = getattr(jphys, cls)(jphys.d_centers_lr, jphys.d_centers_lr)(pred, true)
    got = getattr(tphys, cls)(tphys.d_centers_lr, tphys.d_centers_lr, device="cpu")(pred, true)
    if cls == "DiffractionPipeline":
        assert want > 0
        np.testing.assert_allclose(got, want, rtol=1e-6)
        return
    assert set(got) == set(want) == {"Integral Intensity", "Peak Intensity", "Shape"}
    assert max(want["Integral Intensity"]) > 0  # peaks were matched: the comparison is not vacuous
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-6, atol=1e-9, err_msg=key)
