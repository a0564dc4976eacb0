"""The port's `data/calibration.py` and `data/real.py` against the JAX
package's, on the same seeded inputs: calibrated renders at the detector's
full size, and a reference root fabricated in tmp_path (six
`*_diffraction.npy` patterns and a `segmentation_maps.pkl` DataFrame), since
the real files are not in the repository.

Tolerances: the numpy-only functions (renders, the pulse and stats scales,
`mask_d_bands`, the loaders) are exact. The functions that rebin go through
the port's `Qwrapper` on the CPU (JAX: XLA's segment_sum): their peak tables
must have the same peaks, with d and intensities within 1e-5 relative,
since a bin's fp32 sum may differ in its last bits."""

import pickle

import numpy as np
import pytest
import torch

import swinwnet_tpu.data.calibration as jcal
import swinwnet_tpu.data.real as jreal
import swinwnet_tpu_torch.data.calibration as pcal
import swinwnet_tpu_torch.data.real as preal
from swinwnet_tpu.data.generation import synthesize_pattern as jax_synthesize

RTOL = 1e-5
D_LIST = [1.2, 2.1, 3.3, 4.6]
INTEN = [1.0, 0.6, 0.8, 0.4]


@pytest.fixture(autouse=True)
def few_threads():
    torch.set_num_threads(2)


def pattern_and_mask(seed=4, d_list=D_LIST, inten=INTEN, H=250, W=480):
    img = jcal.render_calibrated(d_list, inten, H=H, W=W, seed=seed)
    clean = jax_synthesize(d_list, inten, H=H, W=W, seed=None, background=0.0)
    return img, (clean > clean.max() * 5e-3).astype(np.float32)


def same_table(got, want):
    assert len(got) == len(want) > 0
    for p, q in zip(got, want):
        assert p.keys() == q.keys()
        for k in q:
            np.testing.assert_allclose(np.asarray(p[k], np.float64), np.asarray(q[k], np.float64),
                                       rtol=RTOL, atol=1e-9, err_msg=k)


def same_spec(got, want):
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(np.asarray(got[k], np.float64), np.asarray(want[k], np.float64),
                                   rtol=RTOL, atol=1e-9, err_msg=k)


@pytest.mark.parametrize("us", [10.0, 150.0, 300.0])
def test_scales(us):
    assert pcal.pulse_width_for_duration(us) == jcal.pulse_width_for_duration(us)
    assert pcal.pulse_width_for_duration(us, 3.0) == jcal.pulse_width_for_duration(us, 3.0)
    assert pcal.stats_scale(us * 1e6) == jcal.stats_scale(us * 1e6)
    assert (pcal.REAL_BASELINE_MU, pcal.REAL_BASELINE_SIGMA, pcal.REAL_RESOLUTION, pcal.TOF_TAIL_LAMBDA) == (
        jcal.REAL_BASELINE_MU, jcal.REAL_BASELINE_SIGMA, jcal.REAL_RESOLUTION, jcal.TOF_TAIL_LAMBDA)


@pytest.mark.parametrize("kw", [dict(seed=4), dict(seed=5, stats=1e8, pulse_duration_us=300.0, beam_amp=3.0),
                                dict(seed=6, baseline=False, speckle_k=2.0, H=125, W=240)])
def test_render_calibrated_exact(kw):
    np.testing.assert_array_equal(pcal.render_calibrated(D_LIST, INTEN, **kw),
                                  jcal.render_calibrated(D_LIST, INTEN, **kw))


@pytest.mark.parametrize("grid", ["lr", "hr"])
def test_detect_table(grid):
    img, mask = pattern_and_mask()
    same_table(pcal.detect_table(img, mask, grid, device="cpu"), jcal.detect_table(img, mask, grid))
    same_table(pcal.detect_table(img, None, grid, device="cpu"), jcal.detect_table(img, None, grid))


def test_detect_union_table():
    img, mask = pattern_and_mask(seed=7, d_list=[0.55, 0.62, 1.4, 3.1], inten=[0.5, 0.4, 1.0, 0.7])
    same_table(pcal.detect_union_table(img, mask, device="cpu"), jcal.detect_union_table(img, mask))


def test_extract_crystal_spec():
    img, mask = pattern_and_mask()
    same_spec(pcal.extract_crystal_spec(img, mask, device="cpu"), jcal.extract_crystal_spec(img, mask))
    same_spec(pcal.extract_crystal_spec(img, None, d_max=3.0, device="cpu"),
              jcal.extract_crystal_spec(img, None, d_max=3.0))


def test_mask_d_bands_exact():
    _, mask = pattern_and_mask()
    np.testing.assert_array_equal(pcal.mask_d_bands(mask), jcal.mask_d_bands(mask))
    assert pcal.mask_d_bands(np.zeros_like(mask)).size == 0


def test_fit_width_model():
    img, mask = pattern_and_mask(seed=8)
    assert pcal.fit_width_model(img, mask, device="cpu") == jcal.fit_width_model(img, mask)


def test_refine_crystal_spec():
    img, mask = pattern_and_mask()
    spec = jcal.extract_crystal_spec(img, mask)
    got = pcal.refine_crystal_spec(spec, img, mask, iters=3, device="cpu")
    same_spec(got, jcal.refine_crystal_spec(spec, img, mask, iters=3))
    assert {"resolution", "pulse_sigma_lambda", "pulse_duration_us"} <= got.keys()


# ---------------------------------------------------------------------------
# real.py and the library built from it, on a fabricated reference root
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def reference_root(tmp_path_factory):
    pd = pytest.importorskip("pandas")
    root = tmp_path_factory.mktemp("reference")
    (root / "datasets").mkdir()
    rng = np.random.default_rng(0)
    rows = []
    for i, name in enumerate(jreal.REAL_PATTERN_CRYSTALS):
        d_list = np.sort(rng.uniform(0.8, 5.0, 4))
        inten = rng.uniform(0.4, 1.0, 4)
        img, mask = pattern_and_mask(seed=20 + i, d_list=d_list, inten=inten)
        np.save(root / "datasets" / f"{name}_diffraction.npy", img)
        rows.append({"Matrix": np.nan, "Crystal": name, "Stats": 5e8, "Mask": mask.astype(np.uint8)})
    rows.append({"Matrix": np.nan, "Crystal": "Fe", "Stats": 5e8, "Mask": np.zeros((250, 480), np.uint8)})
    with open(root / "datasets" / "segmentation_maps.pkl", "wb") as f:
        pickle.dump(pd.DataFrame(rows), f)
    return str(root)


def test_real_loaders_exact(reference_root, tmp_path):
    assert preal.REAL_PATTERN_CRYSTALS == jreal.REAL_PATTERN_CRYSTALS
    assert preal.reference_available(reference_root) and jreal.reference_available(reference_root)
    assert not preal.reference_available(str(tmp_path)) and not jreal.reference_available(str(tmp_path))
    np.testing.assert_array_equal(preal.load_real_patterns(root=reference_root),
                                  jreal.load_real_patterns(root=reference_root))
    names = ["Si", "Rb"]
    np.testing.assert_array_equal(preal.load_real_patterns(names, reference_root),
                                  jreal.load_real_patterns(names, reference_root))
    for sel in (None, names):
        got, want = preal.load_real_masks(sel, reference_root), jreal.load_real_masks(sel, reference_root)
        assert list(got) == list(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
    assert len(preal.load_real_masks(root=reference_root)) == 7
    gi, gm, gn = preal.load_real_eval_set(reference_root)
    wi, wm, wn = jreal.load_real_eval_set(reference_root)
    assert gn == wn and gi.shape == (6, 250, 480)
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_array_equal(gm, wm)


def test_reference_root_default_is_the_variable(monkeypatch, tmp_path):
    import importlib

    monkeypatch.setenv("SWINWNET_REFERENCE_ROOT", str(tmp_path))
    try:
        assert importlib.reload(preal).REFERENCE_ROOT == str(tmp_path)
    finally:
        monkeypatch.undo()
        importlib.reload(preal)


@pytest.mark.parametrize("refined", [False, True])
def test_real_crystal_library(reference_root, refined):
    got = pcal.real_crystal_library(reference_root, refined=refined, device="cpu")
    want = jcal.real_crystal_library(reference_root, refined=refined)
    assert list(got) == list(want) == list(jreal.REAL_PATTERN_CRYSTALS)
    for name in want:
        same_spec(got[name], want[name])
