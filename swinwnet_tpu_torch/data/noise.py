"""Noise-injection evaluation protocol and the training augmentations (a
copy of `swinwnet_tpu/data/noise.py`; numpy only).

The published metrics average 5 passes with additive N(mu=100, sigma=20)
noise applied to each test pattern before inference
(experiments/Physycal_metrics_test.ipynb cell 14; SURVEY.md §6).
"""

from __future__ import annotations

import numpy as np


def add_eval_noise(images: np.ndarray, mu: float = 100.0, sigma: float = 20.0, seed: int = 0):
    rng = np.random.default_rng(seed)
    return images + rng.normal(mu, sigma, size=images.shape).astype(images.dtype)


def make_train_noise_augment(mu_range=(0.0, 150.0), sigma_frac: float = 0.2):
    """Per-batch additive-noise augmentation for synthetic training data.

    The published eval protocol injects N(mu=100, sigma=0.2*mu) into every
    test pattern before inference (Physycal_metrics_test.ipynb cell 14). The
    real McStas patterns the reference trained on carry an instrument
    background of the same order, so the released weights are robust to that
    injection; bare synthetic renders are not (QUALITY_r03 diagnosis: a model
    with train HR-IoU 0.97 over-dilated to recall=1.0 / precision=0.39 the
    moment the eval noise was applied). This augmentation closes the gap on
    the data side: each training batch gets additive Gaussian noise with mu
    drawn uniformly from `mu_range` (covering the eval protocol's mu=100)
    and sigma = `sigma_frac` * mu, the protocol's own sigma rule.

    Returns an `augment(rng, images) -> images` callable for
    `ArrayLoader(augment=...)`.
    """

    def augment(rng: np.random.Generator, images: np.ndarray) -> np.ndarray:
        mu = rng.uniform(*mu_range)
        return images + rng.normal(mu, sigma_frac * mu, size=images.shape).astype(
            images.dtype
        )

    return augment


def make_theta_flip_augment(p: float = 0.5):
    """Per-sample detector-mirror augmentation (joint image+mask).

    The detector's scattering-angle axis spans theta in [-170, 170] deg over
    the W columns with the direct beam at theta=0 (the center column), and
    every physical quantity of the pattern depends on theta only through
    |theta| (d = lambda / (2 sin(|theta|/2)) — Diffraction_metrics.py:43-49),
    so mirroring a pattern along W yields an equally valid detector image of
    the same crystal. Flipping image and mask together doubles the effective
    training diversity for free — a substitute for the reference's
    4560-pattern McStas sweep, whose simulator is not part of the repo
    (BLOCKERS.md).

    Returns a `joint_augment(rng, images, masks) -> (images, masks)` callable
    for `ArrayLoader(joint_augment=...)`; masks may be None (images-only
    datasets). Flip decisions are drawn per sample from `rng`.
    """

    def joint_augment(rng: np.random.Generator, images: np.ndarray, masks):
        flip = rng.random(len(images)) < p
        if not flip.any():
            return images, masks
        images = images.copy()
        images[flip] = images[flip, ..., ::-1]
        if masks is not None:
            masks = masks.copy()
            masks[flip] = masks[flip, ..., ::-1]
        return images, masks

    return joint_augment
