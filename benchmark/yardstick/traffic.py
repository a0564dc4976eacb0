"""Synthetic detector patterns, drawn from the seed on the device.

A copy of the program's `synthesize_dataset` / `synthesize_pattern`
(`swinwnet_tpu_torch/data/generation.py`), computed for the whole pool at
once: each reflection d paints its Bragg locus lambda = 2 d sin(|theta|/2)
across the 250 x 480 (lambda x theta) detector with a Gaussian wavelength
profile of width sqrt(pulse^2 + (res * lambda)^2), a transmitted-beam
streak is added, the image is blurred along theta, scaled to counts over a
flat background and Poisson-sampled. The peak mask is the beam-free,
noiseless render above 0.5% of its maximum. Patterns differ from seed to
seed, sizes never do.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .weights import TRAFFIC, sub_seed


def _d_lists(rng: np.random.Generator, n: int, peaks: Tuple[int, int], d_range: Tuple[float, float],
             min_sep: float, max_peaks: int):
    """[n, max_peaks] d-spacings (padded with 1.0) and intensities (0 where
    padded): a count of reflections in `peaks`, d-spacings at least `min_sep`
    apart, intensities uniform in [0.5, 3)."""
    d = np.ones((n, max_peaks))
    inten = np.zeros((n, max_peaks))
    for i in range(n):
        k = int(rng.integers(*peaks))
        out = []
        for _ in range(50 * k):
            c = float(rng.uniform(*d_range))
            if all(abs(c - o) >= min_sep for o in out):
                out.append(c)
            if len(out) == k:
                break
        out = np.sort(out)
        d[i, :len(out)] = out
        inten[i, :len(out)] = rng.uniform(0.5, 3.0, size=len(out))
    return d, inten


def _blur_theta(img: torch.Tensor, sigma: float) -> torch.Tensor:
    """Gaussian blur along the last axis, edges repeated."""
    radius = max(1, int(3.0 * sigma + 0.5))
    x = torch.arange(-radius, radius + 1, dtype=img.dtype, device=img.device)
    k = torch.exp(-0.5 * (x / sigma) ** 2)
    k = (k / k.sum()).reshape(1, 1, -1)
    n, H, W = img.shape
    flat = F.pad(img.reshape(n * H, 1, W), (radius, radius), mode="replicate")
    return F.conv1d(flat, k).reshape(n, H, W)


def patterns(params: dict, n: int, seed: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """`n` noisy patterns [n, H, W] fp32 and their peak masks [n, H, W] fp32,
    on `device`, from `seed` and the geometry and physics in `params`."""
    H, W = params["height"], params["width"]
    rng = np.random.default_rng(sub_seed(seed, TRAFFIC))
    d, inten = _d_lists(rng, n, tuple(params["peaks"]), tuple(params["d_range"]), params["min_sep"],
                        params["peaks"][1])
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, TRAFFIC))
    f64 = dict(dtype=torch.float64, device=device)
    theta_deg = torch.linspace(*params["theta_range"], W, **f64)
    sin_half = torch.sin(torch.deg2rad(theta_deg.abs()) * 0.5)  # [W]
    lam = torch.linspace(*params["lambda_range"], H, **f64)[:, None]  # [H, 1]
    lo, hi = params["lambda_range"]
    d_t, i_t = torch.as_tensor(d, **f64), torch.as_tensor(inten, **f64)
    clean = torch.zeros(n, H, W, **f64)
    for j in range(d.shape[1]):
        lb = 2.0 * d_t[:, j, None, None] * sin_half[None, None, :]  # [n, 1, W]
        band = (lb > lo) & (lb < hi)
        sigma = torch.sqrt(params["pulse_width"] ** 2 + (params["resolution"] * lb) ** 2)
        clean += i_t[:, j, None, None] * torch.exp(-0.5 * ((lam[None] - lb) / sigma) ** 2) * band
    beam = (torch.exp(-0.5 * (theta_deg / 3.5) ** 2)[None, :] * (lam ** 2) * torch.exp(-lam / 0.9))
    beam = beam / beam.max()
    img = _blur_theta(clean + params["direct_beam"] * beam[None], params["theta_blur"])
    clean = _blur_theta(clean, params["theta_blur"]) * params["counts_scale"]
    rate = torch.clamp(img * params["counts_scale"] + params["background"], min=0.0)
    noisy = torch.poisson(rate, generator=gen).float()
    thr = clean.amax(dim=(1, 2), keepdim=True) * 5e-3
    masks = (clean > torch.where(thr > 0, thr, torch.ones_like(thr))).float()
    return noisy, masks


DETECTOR = {
    # the detector and the renderer's defaults, as `synthesize_dataset` draws them
    "height": 250, "width": 480, "theta_range": [-170.0, 170.0], "lambda_range": [0.1, 10.0],
    "peaks": [4, 9], "d_range": [0.8, 4.2], "min_sep": 0.25, "pulse_width": 0.04, "resolution": 0.02,
    "theta_blur": 1.5, "direct_beam": 4.0, "background": 2.0, "counts_scale": 1000.0,
}


def detector(traffic: dict, config: dict) -> dict:
    """The renderer's parameters: the defaults, the configuration's
    geometry, the traffic's own settings over both."""
    out = dict(DETECTOR, height=config["height"], width=config["width"])
    out.update(traffic.get("detector", {}))
    return out


def error_channel(x: torch.Tensor) -> torch.Tensor:
    """[n, H, W] counts -> [n, 2, H, W]: counts and their Poisson error sqrt(|I|)."""
    return torch.stack([x, torch.sqrt(torch.abs(x))], dim=1)

