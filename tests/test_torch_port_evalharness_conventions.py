"""The eval harness's SR branch with the notebook norm convention and with
an AlphaPolicy, against the JAX package's harness (the reference convention
is in tests/test_torch_port_evalharness.py, with the same model, data and
tolerances): the SR-branch tensors within 1e-4 of their max (1e-5 for the
LR ones), the upscaler metrics (PSNR within 1e-4 dB, SSIM within 1e-5) and
the physical metrics (1e-4 relative)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_port_helpers as h
from swinwnet_tpu.evalharness import MetricsCalculator as JaxMetricsCalculator
from swinwnet_tpu.models import AlphaPolicy as JaxAlphaPolicy
from swinwnet_tpu_torch.compat import state_dict_from_jax
from swinwnet_tpu_torch.evalharness import MetricsCalculator
from swinwnet_tpu_torch.models import AlphaPolicy

torch.set_num_threads(1)

S = h.HARNESS_HW


def calculators(kind):
    jmodel, params, port, jloader, loader = h.harness_setup(seed=8)
    if kind == "notebook":
        return (JaxMetricsCalculator(jmodel, params, jloader, verbose=False, norm_convention="notebook"),
                MetricsCalculator(port, loader, verbose=False, norm_convention="notebook"))
    pp = JaxAlphaPolicy().init(jax.random.PRNGKey(3), jnp.zeros((1, 2, S // 2, S // 2)))
    # a bias that puts the gain sigmoid(mu) well away from 1/2
    pp = jax.tree_util.tree_map(np.array, pp)
    pp["params"]["fc"]["bias"] = np.full_like(pp["params"]["fc"]["bias"], -1.5)
    policy = AlphaPolicy(device="cpu")
    policy.load_state_dict(state_dict_from_jax(pp), strict=True)
    return (JaxMetricsCalculator(jmodel, params, jloader, verbose=False, policy=JaxAlphaPolicy(),
                                 policy_variables=pp),
            MetricsCalculator(port, loader, verbose=False, policy=policy))


@pytest.fixture(scope="module", params=["notebook", "policy"])
def runs(request):
    jcalc, calc = calculators(request.param)
    images = next(iter(calc.val_loader))[0]
    stages = (jax.device_get(jcalc._sr_forward(jcalc.variables, jnp.asarray(images))), calc.sr_forward(images))
    return {m: (getattr(jcalc, m)(), getattr(calc, m)())
            for m in ("CalculateUpscalerMetrics", "CalculatePhysycalMetrics")}, stages


def test_sr_branch_matches_jax(runs):
    want, got = runs[1]
    for i, name in enumerate(("images_downscaled", "norm_images", "sr_out", "denorm_sr_out")):
        h.assert_close(got[i], want[i], tol=1e-5 if i < 2 else 1e-4, name=name)


def test_upscaler_metrics_match_jax(runs):
    want, got = runs[0]["CalculateUpscalerMetrics"]
    assert list(got) == list(want)
    for section in want:
        assert len(got[section]["PSNR"]) == 4
        np.testing.assert_allclose(got[section]["PSNR"], want[section]["PSNR"], rtol=0, atol=1e-4)
        np.testing.assert_allclose(got[section]["SSIM"], want[section]["SSIM"], rtol=0, atol=1e-5)


def test_physical_metrics_match_jax(runs):
    want, got = runs[0]["CalculatePhysycalMetrics"]
    assert list(got) == ["integral", "peak", "shape"]
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-12)


def test_unknown_convention_raises():
    port = h.harness_setup()[2]
    with pytest.raises(ValueError, match="norm_convention"):
        MetricsCalculator(port, [], norm_convention="other")
