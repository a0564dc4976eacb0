"""The eval harness's image metrics (swinwnet_tpu_torch/evalharness/
image_metrics.py) against the JAX package's on the same numpy inputs: the
segmentation scores are ratios of exact counts and must be equal; PSNR is
held within 1e-5 dB and SSIM within 1e-6 (fp32 sums and convolutions in
other orders), on random and on constant images; the batched per-sample
forms equal the JAX functions called sample by sample."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swinwnet_tpu.evalharness import image_metrics as jm
from swinwnet_tpu_torch.evalharness import image_metrics as pm

torch.set_num_threads(1)


def probs_and_masks(seed, B=3, H=40, W=48):
    rng = np.random.default_rng(seed)
    probs = rng.uniform(0, 1, (B, 1, H, W)).astype(np.float32)
    probs[0, 0, :4, :4] = 0.5  # pixels exactly at a threshold
    masks = (rng.uniform(size=(B, 1, H, W)) > 0.7).astype(np.float32)
    masks[2] = 0.0  # a sample with no positive pixel: scores of 0 / eps
    return probs, masks


@pytest.mark.parametrize("threshold", [0.25, 0.5, 0.75])
def test_segmentation_metrics_batch_equal_jax(threshold):
    probs, masks = probs_and_masks(0)
    want = jm.segmentation_metrics_batch(jnp.asarray(probs), jnp.asarray(masks), threshold=threshold)
    got = pm.segmentation_metrics_batch(torch.from_numpy(probs), torch.from_numpy(masks), threshold=threshold)
    assert list(got) == list(pm.METRIC_NAMES) and set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)


def test_one_sample_helpers_equal_jax():
    probs, masks = probs_and_masks(1)
    np.testing.assert_array_equal(pm.binarize_prediction(torch.from_numpy(probs), 0.5).numpy(),
                                  np.asarray(jm.binarize_prediction(jnp.asarray(probs), 0.5)))
    got = pm.confusion_matrix_binary(torch.from_numpy(probs) > 0.5, torch.from_numpy(masks))
    want = jm.confusion_matrix_binary(jnp.asarray(probs) > 0.5, jnp.asarray(masks))
    assert [float(v) for v in got] == [float(v) for v in want]
    got = pm.compute_all_metrics(torch.from_numpy(probs[1]), torch.from_numpy(masks[1]), 0.25)
    want = jm.compute_all_metrics(jnp.asarray(probs[1]), jnp.asarray(masks[1]), 0.25)
    assert {k: float(v) for k, v in got.items()} == {k: float(v) for k, v in want.items()}


def images(kind, seed=2, B=3, C=2, H=40, W=48):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0, 1, (B, C, H, W)).astype(np.float32)
    if kind == "random":
        return a, np.clip(a + 0.1 * rng.standard_normal(a.shape), 0, 1).astype(np.float32)
    # constant and equal: every window's variances cancel to the same bits in
    # pred and target, so SSIM is exactly 1 and the MSE 0 (PSNR at its cap)
    c = np.full_like(a, 0.37)
    return c, c.copy()


@pytest.mark.parametrize("kind", ["random", "constant"])
def test_psnr_and_ssim_match_jax(kind):
    pred, target = images(kind)
    p, t = torch.from_numpy(pred), torch.from_numpy(target)
    assert abs(float(pm.psnr(p, t)) - float(jm.psnr(jnp.asarray(pred), jnp.asarray(target)))) <= 1e-5
    assert abs(float(pm.ssim(p, t)) - float(jm.ssim(jnp.asarray(pred), jnp.asarray(target)))) <= 1e-6
    # per sample, and one channel of it: the JAX functions called on [1, C, H, W] slices
    for ch in (slice(None), slice(1, 2)):
        want_p = [float(jm.psnr(jnp.asarray(pred[b:b + 1, ch]), jnp.asarray(target[b:b + 1, ch])))
                  for b in range(len(pred))]
        want_s = [float(jm.ssim(jnp.asarray(pred[b:b + 1, ch]), jnp.asarray(target[b:b + 1, ch])))
                  for b in range(len(pred))]
        np.testing.assert_allclose(pm.psnr_per_sample(p[:, ch], t[:, ch]).numpy(), want_p, rtol=0, atol=1e-5)
        np.testing.assert_allclose(pm.ssim_per_sample(p[:, ch], t[:, ch]).numpy(), want_s, rtol=0, atol=1e-6)


def test_ssim_of_two_different_constant_images():
    """Two constants: SSIM is (2 mu_p mu_t + c1) / (mu_p^2 + mu_t^2 + c1)
    in exact arithmetic, but each window's variance E[x^2] - E[x]^2 is then
    fp32 rounding of E[x^2] (~6e-8) against c2 = 9e-4, so an fp32 SSIM is
    off that value by ~1e-4 relative: the JAX package's by 1.0e-4, the
    port's (other convolution sums) by 3.2e-4 at (0.25, 0.75). Both are held
    to the closed form within 1e-3; an equality with JAX at 1e-6 is not
    defined here. PSNR is 10 log10(1 / (hi - lo)^2): the port's within 1e-5
    dB of it; the JAX package's fp32 mean of 7680 equal squares is off by
    up to 7.8e-5 dB (at 0.1, 0.9), so the two agree within 1e-4 dB."""
    for lo, hi in ((0.25, 0.75), (0.1, 0.9), (0.5, 0.6)):
        a, b = np.full((2, 2, 40, 48), lo, np.float32), np.full((2, 2, 40, 48), hi, np.float32)
        exact = (2 * lo * hi + 1e-4) / (lo * lo + hi * hi + 1e-4)
        assert abs(float(pm.ssim(torch.from_numpy(a), torch.from_numpy(b))) - exact) <= 1e-3
        assert abs(float(jm.ssim(jnp.asarray(a), jnp.asarray(b))) - exact) <= 1e-3
        got = float(pm.psnr(torch.from_numpy(a), torch.from_numpy(b)))
        assert abs(got - 10 * np.log10(1 / (np.float32(hi) - np.float32(lo)) ** 2)) <= 1e-5
        assert abs(got - float(jm.psnr(jnp.asarray(a), jnp.asarray(b)))) <= 1e-4


def test_identical_images_give_infinite_psnr_cap_and_ssim_one():
    a = torch.rand(2, 1, 20, 20, generator=torch.Generator().manual_seed(0))
    assert float(pm.psnr(a, a)) == pytest.approx(200.0)  # mse clamped at 1e-20
    assert float(pm.ssim(a, a)) == pytest.approx(1.0, abs=1e-6)
