"""The quality recipe's eval protocol and diagnostics, and the classical
baselines (swinwnet_tpu_torch/recipes) against the JAX scripts and package
on the same weights and data.

* eval protocol: `run_eval_protocol` against the same sequence through the
  JAX `MetricsCalculator` (reference and notebook conventions) and
  `add_eval_noise`, with the tolerances of tests/test_torch_port_evalharness.py:
  segmentation scores equal, PSNR within 1e-4 dB, SSIM within 1e-5, the
  physical metrics within 1e-4 relative; `diagnostics` within 1e-4.
* classical baselines: the recipe's `main` against the JAX script's `main`
  with the same flags on the synthetic eval crystals: every per-sample
  metric within 1e-4 relative, and the summary's keys those of the
  committed CLASSICAL_r04_syn.json."""

import json
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_port_recipe_helpers as r
from swinwnet_tpu.data import ArrayLoader as JaxArrayLoader
from swinwnet_tpu.data.noise import add_eval_noise as jax_eval_noise
from swinwnet_tpu.evalharness import MetricsCalculator as JaxMetricsCalculator
from swinwnet_tpu.models import SwinWNet as JaxSwinWNet
from swinwnet_tpu.pipelines.inference import make_inference_fn
from swinwnet_tpu_torch.compat import jax_tree_from_state_dict
from swinwnet_tpu_torch.recipes import classical_baselines, quality_run

torch.set_num_threads(1)

PSNR_ATOL, SSIM_ATOL, PHYS_RTOL, DIAG_TOL = 1e-4, 1e-5, 1e-4, 1e-4
CLASSICAL_RTOL = 1e-4


@pytest.fixture(scope="module")
def eval_setup():
    """The tiny recipe model (seed 0's weights) on both sides and the
    held-out renders."""
    args = r.tiny_args()
    _, _, _, images, masks = quality_run.render_data(args)
    model = quality_run.build_model(args, "cpu")
    params = jax_tree_from_state_dict(model.state_dict())
    return args, model, JaxSwinWNet(**quality_run.TINY), {"params": params}, images, masks


def jax_eval_protocol(jmodel, variables, images, masks, batch, passes):
    """scripts/quality_run.py:286-320 on the JAX package."""
    calc = JaxMetricsCalculator(jmodel, variables, None, verbose=False)
    calc_nb = JaxMetricsCalculator(jmodel, variables, None, verbose=False, norm_convention="notebook")
    out = []
    for k in range(passes):
        noisy = jax_eval_noise(images[:, None].astype(np.float32), seed=k)[:, 0]
        calc.val_loader = calc_nb.val_loader = JaxArrayLoader(noisy, masks, batch_size=batch)
        out.append((calc.CalculateSegmentationMetrics(), calc.CalculateUpscalerMetrics(),
                    calc_nb.CalculatePhysycalMetrics()))
    seg, ups, phys = out[0]
    for s2, u2, p2 in out[1:]:
        for res in seg:
            for thr in seg[res]:
                seg[res][thr].extend(s2[res][thr])
        for sec in ups:
            for m in ups[sec]:
                ups[sec][m].extend(u2[sec][m])
        for m in phys:
            phys[m] = np.concatenate([phys[m], p2[m]])
    return seg, ups, phys


def test_eval_protocol_matches_the_jax_sequence(eval_setup):
    args, model, jmodel, variables, images, masks = eval_setup
    seg, ups, phys = quality_run.run_eval_protocol(model, images, masks, args.batch, 2)
    jseg, jups, jphys = jax_eval_protocol(jmodel, variables, images, masks, args.batch, 2)
    n = len(images) * 2
    assert seg.keys() == jseg.keys() and ups.keys() == jups.keys() and phys.keys() == jphys.keys()
    for res in jseg:
        assert seg[res].keys() == jseg[res].keys()
        for thr, rows in jseg[res].items():
            assert len(seg[res][thr]) == len(rows) == n
            for got, want in zip(seg[res][thr], rows):
                assert got.keys() == want.keys()
                np.testing.assert_allclose([got[k] for k in want], [want[k] for k in want], rtol=0, atol=1e-6)
    for sec in jups:
        np.testing.assert_allclose(ups[sec]["PSNR"], jups[sec]["PSNR"], rtol=0, atol=PSNR_ATOL)
        np.testing.assert_allclose(ups[sec]["SSIM"], jups[sec]["SSIM"], rtol=0, atol=SSIM_ATOL)
    for k in jphys:
        assert len(phys[k]) == n
        np.testing.assert_allclose(phys[k], jphys[k], rtol=PHYS_RTOL, atol=1e-12)
    # and the summary entries built from them
    sums = quality_run.metric_summaries(seg, ups, phys)
    assert sums["segmentation"]["Low Res"]["0.50 thrashold"]["IoU"] == pytest.approx(
        [np.mean([x["IoU"] for x in jseg["Low Res"]["0.50 thrashold"]]),
         np.std([x["IoU"] for x in jseg["Low Res"]["0.50 thrashold"]], ddof=1)], abs=1e-6)


def test_diagnostics_match_the_jax_stages(eval_setup):
    args, model, jmodel, variables, images, _ = eval_setup
    got = quality_run.diagnostics(model, images, args.batch)
    stages = make_inference_fn(jmodel)(variables, jnp.asarray(images[: args.batch, None]))
    want = quality_run.diagnostics_of(np.asarray(stages["seg_map_hr"]), np.asarray(stages["upscaled_denorm"]), images)
    assert got.keys() == want.keys()
    for section, values in want.items():
        assert got[section].keys() == values.keys()
        for k, w in values.items():
            g, w = np.atleast_1d(got[section][k]), np.atleast_1d(w)
            assert np.all(np.abs(g - w) <= DIAG_TOL * np.maximum(np.abs(w), 1.0)), (section, k, g, w)


@pytest.mark.parametrize("norm", ["notebook", "exact"])
def test_classical_baselines_match_the_jax_script(monkeypatch, tmp_path, norm):
    flags = ["--data", "synthetic", "--norm", norm, "--height", "50", "--width", "60",
             "--eval-renders-per-crystal", "1", "--noise-passes", "2", "--device", "cpu",
             "--baselines", str(tmp_path / "none")]
    monkeypatch.setenv("SWINWNET_COMPILE_CACHE", "0")
    monkeypatch.syspath_prepend(str(r.SCRIPTS))  # the script imports quality_run from its folder
    monkeypatch.setattr(sys, "argv", ["classical_baselines.py", *flags, "--out", str(tmp_path / "J")])
    r.jax_script("classical_baselines").main()
    summary = classical_baselines.main([*flags, "--out", str(tmp_path / "P")])

    with open(r.REPO / "CLASSICAL_r04_syn.json") as f:
        committed = json.load(f)
    with open(tmp_path / "J.json") as f:
        jax_summary = json.load(f)
    assert list(summary) == list(jax_summary) == list(committed)
    assert summary["baselines"].keys() == jax_summary["baselines"].keys() == committed["baselines"].keys()
    for name in ("bilinear", "avgpool"):
        assert set(summary["baselines"][name]) == set(committed["baselines"][name]) - {"vs_published"}
        for kind in ("physical_metrics", "peak_losses"):
            got = json.loads((tmp_path / f"P_{name}_{kind}.json").read_text())
            want = json.loads((tmp_path / f"J_{name}_{kind}.json").read_text())
            committed_keys = json.loads((r.REPO / f"CLASSICAL_r04_syn_{name}_{kind}.json").read_text()).keys()
            assert got.keys() == want.keys() == committed_keys
            for k in want:
                assert len(got[k]) == len(want[k]) == 12
                np.testing.assert_allclose(got[k], want[k], rtol=CLASSICAL_RTOL, atol=1e-9, err_msg=f"{name} {k}")
    assert summary["n_samples"] == jax_summary["n_samples"] == 12
