"""The plain reference of the REINFORCE fine-tune: SwinWNet with its alpha
policy, one step of the upstream pipeline in float32, and the physics
reward written plainly from its specification.

Upstream: `RL_finetuning_pipline.py:11-307` (the step), `RL_policy.py:4-24`
(the policy) and `Diffraction_metrics.py:76-306` (the reward) of
popoff4rtem/SwinWNet-A-Deep-Learning-framework-for-multimodal-processing-
of-2D-neutron-diffraction-data-. It imports nothing of the program under
test. `Model` is `reference.RefSwinWNet` with the policy under `policy.`
(`policy.conv`, `policy.fc`), so one drawn state dict loads into the
program's SwinWNet and AlphaPolicy alike.

One step (`RLStep.step`), TF32 off:
* preprocess, no gradient: the error channel, `segment_1`, the image
  masked by the segmentation's sigmoid, its half-size bilinear copy and
  the full-size copy, each normalized (min-max, log1p above 0.01);
* the policy: conv 2->8 3x3, ReLU, global mean, linear 8->1 gives mu, std
  is 1; the action alpha = mu + std * noise;
* the rollout, no gradient: `upscale` of the half-size copy, times
  sigmoid(alpha), denormalized with the full-size copy's range;
* the reward of the rollout's first channel against the masked image's;
* REINFORCE: loss = -mean(log N(alpha; mu, std) * reward), Adam on the
  policy (lr 1e-4);
* the supervised update: `upscale` again with gradients, times
  sigmoid(mu), lambda_rec * L1 against the normalized full-size copy, and
  AdamW with no decay on what the "rl" stage trains: `upscaler_*` and
  `ca_seg_to_sr` (lr 1e-5).

The reward, per sample: the d-map of the detector (lambda in [0.1, 10] A
over the rows, theta in [-170, 170] degrees over the columns, d = lambda /
(2 sin(|theta| / 2)), pixels with d > 7.5 A dropped), the pixels summed
into the bins of the fixed centres (edges halfway between centres) in
float64 with `index_add_`; `scipy.signal.find_peaks(height=0.05,
distance=10, prominence=0.1, width=5)` on each spectrum; a window of
int(1.5 width) samples each side of a peak (clipped to the spectrum) gives
its integral, its centre of mass and its profile; each predicted peak takes
the true peak nearest in d to its centre of mass and is matched when the
two centres of mass lie within 0.05 A; matched pairs add (log(I + 1) -
log(I' + 1))^2 of their integrals and of their heights, and the W1
distance of their unit-mass profiles resampled onto (d - d_peak) / d_peak
over linspace(-0.03, 0.03, 64). reward = -(2 integral + 1 height + 0.5
shape).

Departures from the upstream:
* the sampled action is detached, as in standard REINFORCE (upstream
  differentiates log_prob through an rsample, which cancels its gradient
  identically);
* the action's noise is an argument (the benchmark draws it from the seed
  on the device, as the program does), not a draw inside the step;
* the policy's update may be handed the reward it weighs by (the
  benchmark hands it the plain reward of the program's own rollouts, so
  that both updates weigh by the same reward);
* the policy's Adam is `RefAdamW` with no decay (the same arithmetic);
* the upscaler's output is cropped to twice the half-size input, as the
  published model crops its padded grid.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from scipy.signal import find_peaks
from torch import nn

from .reference import Products, RefAdamW, RefSwinWNet, denormalize, normalize, with_error_channel

# the detector and the reward's grid (Diffraction_metrics.py; RL_finetuning_pipline.py:19)
THETA_RANGE = (-170.0, 170.0)
LAMBDA_RANGE = (0.1, 10.0)
D_MAX = 7.5
GATES = dict(height=0.05, distance=10, prominence=0.1, width=5)
TOL = 0.05
X_REF = np.linspace(-0.03, 0.03, 64)


class RefAlphaPolicy(nn.Module):
    """RL_policy.py:4-24: conv 2->8 3x3 (zero padding 1), ReLU, global
    average pool, linear 8->1 -> (mu, std = 1)."""

    def __init__(self, prod: Products):
        super().__init__()
        self.prod = prod
        self.conv = nn.Conv2d(2, 8, 3, padding=1)
        self.fc = nn.Linear(8, 1)

    def forward(self, x):
        y = F.relu(self.prod.conv(x, self.conv, padding=1))
        mu = self.prod.linear(y.mean(dim=(2, 3)), self.fc)
        return mu, torch.ones_like(mu)


class Model(RefSwinWNet):
    """SwinWNet and its alpha policy."""

    def __init__(self, cfg: dict, prod: Optional[Products] = None):
        prod = prod or Products()
        super().__init__(cfg, prod)
        self.policy = RefAlphaPolicy(prod)


def rl_trains(name: str) -> bool:
    """Whether the "rl" stage trains the model's parameter `name`."""
    top = name.split(".")[0]
    return top.startswith("upscaler_") or top == "ca_seg_to_sr"


# ---------------------------------------------------------------------------
# The reward
# ---------------------------------------------------------------------------


def bin_index(H: int, W: int, centers: np.ndarray) -> torch.Tensor:
    """[H * W] int64: each pixel's bin, -1 where d > D_MAX."""
    theta = np.deg2rad(np.linspace(*THETA_RANGE, W))
    lam = np.linspace(*LAMBDA_RANGE, H)
    d = lam[:, None] / (2.0 * np.sin(np.abs(theta)[None, :] * 0.5))
    c = centers.astype(np.float32)
    edges = np.concatenate([[c[0] - (c[1] - c[0]) / 2], (c[:-1] + c[1:]) / 2, [c[-1] + (c[-1] - c[-2]) / 2]])
    idx = np.clip(np.searchsorted(edges.astype(np.float32), d.ravel(), side="right") - 1, 0, len(c) - 1)
    return torch.from_numpy(np.where(d.ravel() > D_MAX, -1, idx).astype(np.int64))


def rebin(x: torch.Tensor, index: torch.Tensor, n_bins: int) -> torch.Tensor:
    """[B, 1, H, W] -> [B, n_bins] float64: each pixel added to its bin."""
    flat = x.reshape(x.shape[0], -1).double()
    keep = (index >= 0).nonzero().squeeze(1).to(x.device)
    out = torch.zeros(x.shape[0], n_bins, dtype=torch.float64, device=x.device)
    return out.index_add_(1, index.to(x.device)[keep], flat[:, keep])


def peak_table(I: np.ndarray, d: np.ndarray) -> List[dict]:
    """The gated peaks of one spectrum, each with its grid d, windowed
    centre of mass, integral, height and window (Diffraction_metrics.py:76-144)."""
    centers, props = find_peaks(I, **GATES)
    out = []
    for c, w in zip(centers, props["widths"]):
        half = int(w * 1.5)
        lo, hi = max(c - half, 0), min(c + half, len(I))
        seg_d, seg_I = d[lo:hi], I[lo:hi]
        mass = float(np.sum(seg_I))
        out.append({"d": float(d[c]), "d_com": float(np.sum(seg_d * seg_I) / mass), "integral": mass,
                    "height": float(I[c]), "win_d": seg_d, "win_I": seg_I})
    return out


def _profile(pk: dict) -> Optional[np.ndarray]:
    mass = np.sum(pk["win_I"])
    if mass <= 0:
        return None
    c = np.interp(X_REF, (pk["win_d"] - pk["d"]) / pk["d"], pk["win_I"] / mass, left=0.0, right=0.0)
    c = np.maximum(c, 0)
    return c / (np.sum(c) + 1e-12)


def _shape(a: dict, b: dict) -> float:
    p, q = _profile(a), _profile(b)
    if p is None or q is None:
        return 0.0
    return float(np.sum(np.abs(np.cumsum(p) - np.cumsum(q))) * (X_REF[1] - X_REF[0]))


def _log_err(a: float, b: float) -> float:
    return (math.log(max(a, 0.0) + 1) - math.log(max(b, 0.0) + 1)) ** 2


def sample_metrics(pred: List[dict], true: List[dict]) -> Dict[str, float]:
    """Greedy matching and the sums over matched pairs (Diffraction_metrics.py:209-271)."""
    out = {"integral": 0.0, "height": 0.0, "shape": 0.0}
    if not pred or not true:
        return out
    true_d = np.array([t["d"] for t in true])
    for pk in pred:
        mate = true[int(np.argmin(np.abs(true_d - pk["d_com"])))]
        if abs(pk["d_com"] - mate["d_com"]) > TOL:
            continue
        out["integral"] += _log_err(pk["integral"], mate["integral"])
        out["height"] += _log_err(pk["height"], mate["height"])
        out["shape"] += _shape(pk, mate)
    return out


def metrics(pred_spec: torch.Tensor, true_spec: torch.Tensor, d: np.ndarray) -> Dict[str, torch.Tensor]:
    """Per-sample integral, height and shape errors, each [B] float64 on
    the host, of spectra pairs [B, n] on the grid of centres `d`."""
    pred_np, true_np = pred_spec.double().cpu().numpy(), true_spec.double().cpu().numpy()
    rows = [sample_metrics(peak_table(p, d), peak_table(t, d)) for p, t in zip(pred_np, true_np)]
    return {k: torch.tensor([r[k] for r in rows], dtype=torch.float64) for k in ("integral", "height", "shape")}


class Reward:
    """The reward on the grid of bin centres `centers`, weighted by
    `lambdas` (`lambda_intensity`, `lambda_peak`, `lambda_shape`)."""

    def __init__(self, centers: np.ndarray, lambdas: Dict[str, float]):
        self.centers, self.lambdas = np.asarray(centers), lambdas
        self.index: Dict[tuple, torch.Tensor] = {}

    def rebin(self, x: torch.Tensor) -> torch.Tensor:
        """[B, 1, H, W] -> [B, len(centers)] float64 spectra."""
        H, W = x.shape[-2:]
        if (H, W) not in self.index:
            self.index[(H, W)] = bin_index(H, W, self.centers)
        return rebin(x, self.index[(H, W)], len(self.centers))

    def __call__(self, pred: torch.Tensor, true: torch.Tensor):
        """The reward [B] of rollouts against masked images, each [B, 1, H, W],
        and its metrics."""
        m = metrics(self.rebin(pred), self.rebin(true), self.centers)
        lam = self.lambdas
        return -(lam["lambda_intensity"] * m["integral"] + lam["lambda_peak"] * m["height"]
                 + lam["lambda_shape"] * m["shape"]), m


# ---------------------------------------------------------------------------
# The step
# ---------------------------------------------------------------------------


def apply_action(x: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(alpha.reshape(-1, 1, 1, 1))


def log_prob(alpha, mu, std):
    return (-0.5 * ((alpha - mu) / std) ** 2 - torch.log(std) - 0.5 * math.log(2 * math.pi)).sum(1)


LAMBDAS = ("lambda_rec", "lambda_intensity", "lambda_peak", "lambda_shape")


class RLStep:
    """The fine-tune on `model` (a `Model`), in place, with the constants of
    `config` (its lambdas, `policy_lr`, `model_lr` and `d_centers`, the
    reward's grid): the policy's Adam and the "rl" subset's AdamW.
    `step(images, noise)` returns the step's numbers; `rollouts` keeps each
    step's rollout and masked image, first channels [B, 1, H, W], for the
    physics comparison, and `last_reward` the last step's reward [B] of its
    own rollout."""

    def __init__(self, model: Model, config: dict):
        self.model, self.lambdas = model, {k: float(config[k]) for k in LAMBDAS}
        self.policy_lr, self.model_lr = config["policy_lr"], config["model_lr"]
        self.policy_params = list(model.policy.parameters())
        self.model_params = [p for n, p in model.named_parameters() if rl_trains(n)]
        for n, p in model.named_parameters():
            p.requires_grad_(rl_trains(n) or n.startswith("policy."))
        self.policy_opt = RefAdamW(self.policy_params, 0.0)
        self.model_opt = RefAdamW(self.model_params, 0.0)
        self.reward = Reward(np.linspace(*config["d_centers"]), self.lambdas)
        self.rollouts: List[tuple] = []
        self.last_reward: Optional[torch.Tensor] = None

    def preprocess(self, images: torch.Tensor):
        with torch.no_grad():
            images = with_error_channel(images)
            seg, skips = self.model.segment_1(images)
            seg_images = images * torch.sigmoid(seg)
            half = F.interpolate(seg_images, scale_factor=0.5, mode="bilinear", align_corners=False)
            norm_lr, _ = normalize(half)
            norm_hr, params_hr = normalize(seg_images)
        return seg_images, norm_lr, norm_hr, params_hr, skips

    def rollout(self, norm_lr, skips, alpha, params_hr) -> torch.Tensor:
        with torch.no_grad():
            sr, _ = self.model.upscale(norm_lr, skips)
            return denormalize(apply_action(sr, alpha), params_hr)[:, 0:1]

    def policy_update(self, mu, std, alpha, reward: torch.Tensor) -> torch.Tensor:
        for p in self.policy_params:
            p.grad = None
        loss = -(log_prob(alpha, mu, std) * reward.to(mu.device, mu.dtype)).mean()
        loss.backward()
        self.policy_opt.step(self.policy_lr)
        return loss.detach()

    def model_update(self, norm_lr, skips, mu, norm_hr) -> torch.Tensor:
        for p in self.model_params:
            p.grad = None
        sr, _ = self.model.upscale(norm_lr, skips)
        rec = torch.mean(torch.abs(apply_action(sr, mu.detach()) - norm_hr))
        (self.lambdas["lambda_rec"] * rec).backward()
        self.model_opt.step(self.model_lr)
        return rec.detach()

    def step(self, images: torch.Tensor, noise: torch.Tensor, reward: Optional[torch.Tensor] = None) -> Dict[str, float]:
        """One step; `reward` [B], where given, is what the policy's update
        weighs its log-probabilities by in place of its own rollout's reward
        (which the step still computes, keeps and reports)."""
        seg_images, norm_lr, norm_hr, params_hr, skips = self.preprocess(images)
        mu, std = self.model.policy(norm_lr)
        alpha = (mu.detach() + std * noise).detach()
        pred = self.rollout(norm_lr, skips, alpha, params_hr)
        true = seg_images[:, 0:1]
        own, _ = self.reward(pred, true)
        self.rollouts.append((pred, true))
        policy_loss = self.policy_update(mu, std, alpha, own if reward is None else reward)
        self.last_reward = reward = own
        rec = self.model_update(norm_lr, skips, mu, norm_hr)
        return {"reward": float(reward.mean()), "rec": float(rec), "policy_loss": float(policy_loss),
                "alpha_mean": float(alpha.mean()), "alpha_std": float(alpha.std(unbiased=False))}
