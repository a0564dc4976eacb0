"""Synthetic diffraction data (port of `swinwnet_tpu/data/generation.py`,
reference L0: support_files/Diffraction_generation_script.py +
Diffraction_render_script.py), numpy only.

The reference renders time-of-flight powder patterns of a banana detector
(480 theta bins x 250 lambda bins) with the external McStas simulator,
sweeping 38 crystals x 6 statistics x 20 pulse durations. The JAX package's
`McStasRenderer` drives that simulator and is not ported yet (the simulator
is not installed). `synthesize_pattern` is the self-contained synthetic
Bragg renderer: each reflection d_i paints its Bragg locus
lambda = 2 d_i sin(|theta|/2) across the detector with instrument-like
wavelength broadening and Poisson counting noise, so rebinned peaks land on
the right d-space positions. It is a copy of the JAX package's, on the
port's own `core.config.GEOMETRY`; the same seeds give the same arrays.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

from ..core.config import GEOMETRY

def synthesize_pattern(
    d_list: Sequence[float],
    intensities: Optional[Sequence[float]] = None,
    H: int = GEOMETRY.height,
    W: int = GEOMETRY.width,
    theta_range: Tuple[float, float] = GEOMETRY.theta_range,
    lambda_range: Tuple[float, float] = GEOMETRY.lambda_range,
    pulse_width: float = 0.04,
    resolution: float = 0.02,
    theta_blur: float = 1.5,
    direct_beam: float = 0.0,
    background: float = 2.0,
    counts_scale: float = 1000.0,
    speckle_k: Optional[float] = None,
    theta_mod: float = 0.0,
    theta_mod_scale: int = 30,
    pedestal: float = 0.0,
    pedestal_mult: float = 5.0,
    tof_tail: float = 0.0,
    seed: Optional[int] = 0,
) -> np.ndarray:
    """Render a [H, W] float32 synthetic diffraction pattern.

    Each d in `d_list` contributes intensity along lambda = 2 d sin(|theta|/2)
    with a Gaussian wavelength profile of width
    ``sqrt(pulse_width^2 + (resolution * lambda_bragg)^2)`` (Angstrom):
    `pulse_width` is the constant moderator pulse broadening and `resolution`
    the relative Delta-d/d instrument resolution term — on a TOF
    diffractometer sigma_lambda = r*lambda gives exactly sigma_d/d = r in
    every detector column, so rebinned peaks have constant *relative* width
    (~2% default, matching the width>=5-bin detection gate of the published
    metric spec on the 832/1241-bin d-grids — Diffraction_metrics.py:109-118).

    Per-column Bragg intensity is FLAT in theta: the published real patterns
    (reference datasets/*.npy) show constant column sums away from the direct
    beam, so no Lorentz-style 1/sin factor is applied. (An earlier 1/sin
    variant concentrated 20x-boosted counts into a handful of d-bins near its
    clip plateau, which made every rebinned peak a 1-2-bin spike that failed
    the published width>=5 detection gate — diagnosed round 3.)

    `theta_blur` (sigma in detector columns) models in-plane angular
    divergence; it is what smooths per-d-bin pixel-count aliasing in the
    rebinned spectra, as the real instrument's divergence does.

    `direct_beam` > 0 adds a transmitted-beam streak at theta ~ 0 with a
    moderator-like lambda spectrum, amplitude `direct_beam` relative to the
    Bragg scale (real patterns show a ~5-20x hot band within |theta| < 10
    degrees). It maps to d > 7.5 A under the rebinners' d-mask, so it never
    pollutes I(d) — but segmentation models must learn to reject it, exactly
    as with the real data.

    `theta_mod` > 0 modulates each reflection's intensity ALONG its Bragg
    arc by a smooth log-normal theta-profile (sigma = theta_mod, correlation
    length `theta_mod_scale` columns): real powder arcs are not flat —
    preferred orientation, absorption and detector acceptance modulate them
    by tens of percent across theta, which decorrelates the window sums the
    d-space metrics compare between the HR and LR grids. Deterministic per
    (seed, reflection) so a (noisy, clean-mask) render pair sees the same
    arcs when the same seed is passed.

    `speckle_k` models McStas' weighted-ray Monte-Carlo variance (round-4
    calibration): the real reference patterns are strongly speckled inside
    peak regions — relative local roughness 0.28-1.13 vs a 3x3 mean,
    i.e. the equivalent of only ~1-10 *effective* rays per pixel, far
    rougher than Poisson noise of the stored count values. Each signal pixel
    (Bragg + beam, post-blur) is multiplied by an independent
    Gamma(k, 1/k) factor (mean 1, relative sigma 1/sqrt(k)); k ~ 1-10
    reproduces the measured roughness. Applied only when `seed` is set.

    Poisson noise is applied on top of a flat background when `seed` is not
    None.
    """
    d_list = np.asarray(d_list, dtype=np.float64)
    if intensities is None:
        intensities = np.ones_like(d_list)
    intensities = np.asarray(intensities, dtype=np.float64)

    theta_deg = np.linspace(theta_range[0], theta_range[1], W)
    theta = np.deg2rad(np.abs(theta_deg))
    lam = np.linspace(lambda_range[0], lambda_range[1], H)
    lam_grid = lam[:, None]  # [H, 1]
    sin_half = np.sin(theta * 0.5)[None, :]  # [1, W]

    mod_rng = None
    if theta_mod > 0.0:
        mod_rng = np.random.default_rng((0 if seed is None else int(seed), 7919))

    img = np.zeros((H, W), dtype=np.float64)
    for d, inten in zip(d_list, intensities):
        lam_bragg = 2.0 * d * sin_half  # [1, W] per-column Bragg wavelength
        in_band = (lam_bragg > lambda_range[0]) & (lam_bragg < lambda_range[1])
        sigma = np.sqrt(pulse_width**2 + (resolution * lam_bragg) ** 2)
        profile = np.exp(-0.5 * ((lam_grid - lam_bragg) / sigma) ** 2)
        if pedestal > 0.0:
            # diffuse pedestal under each arc (thermal-diffuse scattering +
            # moderator tails): `pedestal` of the core's mass spread over a
            # `pedestal_mult`x wider profile. The real six patterns spend
            # 101 of 832 LR d-bins above 5% of max vs 38 for core-only
            # renders — this inter-peak plateau is what the published
            # metrics' int(1.5*width) windows integrate on the broadened
            # pooled-LR side.
            ped = np.exp(-0.5 * ((lam_grid - lam_bragg) / (pedestal_mult * sigma)) ** 2)
            profile = profile + (pedestal / pedestal_mult) * ped
        arc = inten * profile * in_band
        if mod_rng is not None:
            z = _gaussian_blur_axis1(mod_rng.normal(size=(1, W)), float(theta_mod_scale))
            z = z / max(float(z.std()), 1e-9)
            arc = arc * np.exp(theta_mod * z - 0.5 * theta_mod**2)
        img += arc

    if tof_tail > 0.0:
        # moderator storage-time decay: every arrival gets an exponential
        # tail toward LONGER wavelength (later arrival), time constant
        # `tof_tail` Angstrom (lambda = 3956 t / L maps decay time linearly
        # to lambda). Linear in the image, so one causal IIR pass along the
        # lambda axis after the reflection sum: y[i] = (1-a) x[i] + a y[i-1]
        # (unit-mass exponential kernel). This is what makes TOF peaks
        # asymmetric (sharp rise, slow decay) — a pure Gaussian profile
        # rebins too consistently between the HR and pooled-LR d-grids and
        # under-drives the published Shape (EMD) metric.
        dlam = (lambda_range[1] - lambda_range[0]) / max(H - 1, 1)
        a = float(np.exp(-dlam / tof_tail))
        out = np.empty_like(img)
        out[0] = (1.0 - a) * img[0]
        for i in range(1, H):
            out[i] = (1.0 - a) * img[i] + a * out[i - 1]
        # renormalize: the IIR preserves mass only asymptotically; keep the
        # pattern's total unchanged so amp calibration stays valid
        tot_in, tot_out = img.sum(), out.sum()
        img = out * (tot_in / tot_out) if tot_out > 0 else out

    if direct_beam > 0.0:
        # transmitted beam: Gaussian in theta (sigma ~3.5 deg), Maxwellian-ish
        # lambda spectrum peaked near 1.5 A
        beam_theta = np.exp(-0.5 * (theta_deg / 3.5) ** 2)[None, :]
        beam_lam = (lam_grid**2) * np.exp(-lam_grid / 0.9)
        beam_lam = beam_lam / beam_lam.max()
        img += direct_beam * beam_lam * beam_theta

    if theta_blur > 0.0:
        img = _gaussian_blur_axis1(img, theta_blur)

    if seed is not None:
        rng = np.random.default_rng(seed)
        if speckle_k is not None and speckle_k > 0:
            img = img * rng.gamma(speckle_k, 1.0 / speckle_k, img.shape)
        img = img * counts_scale + background
        img = rng.poisson(np.maximum(img, 0)).astype(np.float64)
    else:
        img = img * counts_scale + background
    return img.astype(np.float32)


def _gaussian_blur_axis1(img: np.ndarray, sigma: float) -> np.ndarray:
    """Small separable Gaussian blur along axis 1 (theta columns)."""
    radius = max(1, int(3.0 * sigma + 0.5))
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    k /= k.sum()
    pad = np.pad(img, ((0, 0), (radius, radius)), mode="edge")
    return sum(w * pad[:, j : j + img.shape[1]] for j, w in enumerate(k))


def sample_d_list(
    rng: np.random.Generator,
    n_peaks: int,
    d_range: Tuple[float, float] = (0.8, 4.2),
    min_sep: float = 0.25,
) -> np.ndarray:
    """Sample `n_peaks` interplanar distances with a minimum separation.

    Real powder patterns concentrate their strong reflections below ~4 A with
    well-separated d's (reference datasets: Si detects at 0.55-3.09 A); the
    separation also keeps peaks resolvable under the published distance=10-bin
    / tol=0.05 A matching gates on the 832/1241-bin d-grids."""
    out: list = []
    for _ in range(50 * n_peaks):
        c = float(rng.uniform(*d_range))
        if all(abs(c - o) >= min_sep for o in out):
            out.append(c)
        if len(out) == n_peaks:
            break
    return np.sort(np.asarray(out))


def synthesize_dataset(
    n_samples: int,
    n_peaks_range: Tuple[int, int] = (4, 9),
    d_range: Tuple[float, float] = (0.8, 4.2),
    direct_beam: float = 4.0,
    seed: int = 0,
    **kwargs,
):
    """[N, H, W] patterns + [N, H, W] uint8 ground-truth peak masks.

    Images include the direct-beam streak (as real patterns do); masks are
    derived from a beam-free noiseless render, so segmentation must learn to
    reject the beam exactly as with the real labeled data."""
    rng = np.random.default_rng(seed)
    images, masks = [], []
    for i in range(n_samples):
        n_peaks = int(rng.integers(*n_peaks_range))
        d_list = sample_d_list(rng, n_peaks, d_range)
        inten = rng.uniform(0.5, 3.0, size=len(d_list))
        img = synthesize_pattern(
            d_list, inten, seed=seed + 1000 + i, direct_beam=direct_beam, **kwargs
        )
        clean = synthesize_pattern(d_list, inten, seed=None, background=0.0, **kwargs)
        thr = float(clean.max()) * 5e-3 if clean.max() > 0 else 1.0
        masks.append((clean > thr).astype(np.uint8))
        images.append(img)
    return np.stack(images), np.stack(masks)
