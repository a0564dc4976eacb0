"""REINFORCE fine-tuning of the upscaler with a physics-based reward (port
of `swinwnet_tpu/train/rl.py`; reference: RL_finetuning_pipline.py:11-307).

One step (`rl_step`), on the model's device throughout:
* the frozen-segmentator preprocess under `torch.no_grad()`;
* the policy update: a sampled action alpha = mu + std * noise, the reward
  of a no-grad rollout (upscale -> apply_action -> denormalize -> d-space
  rebin -> on-device peak metrics), and REINFORCE's
  loss = -mean(log_prob(alpha) * reward) with an Adam step;
* the supervised model update: lambda_rec * L1 between
  apply_action(upscale(norm_lr), mu) and the normalized HR target, with
  AdamW (no decay) over what the "rl" stage trains (upscaler_* and
  ca_seg_to_sr).

It returns the step's nine metrics; given a `rollout` dict, it also fills
it with the per-sample reward and the two images that reward was computed
on, which `make_rl_train_step` keeps as `RLState.rollout`, so that a check
can recompute the reward of the very rollouts the program rewarded.

The reward never leaves the card: the reference computes it with scipy on
the CPU every batch (RL_finetuning_pipline.py:202-230); here it is
`physics.device_metrics` over `Qwrapper.rebin` spectra, and the step reads
nothing back from the device (the distance gate loops a static count of
ranks). The policy's Adam is `optax.adam`, which is the port's `AdamW`
with weight_decay 0.

`make_rl_train_step` is the JAX factory: `step(state: RLState, images) ->
(state, metrics)`, `rl_step` as one program (`core.graphs`: on the card a
CUDA graph captured once per batch shape that holds the preprocess, the
rollout and its reward, both backwards and both updates, replayed with one
host call). `RLTrainer` steps through it.

Tracing: the step's phases are device spans (`utils.profiling.device_span`):
`rl.preprocess`, `rl.rollout`, `rl.reward` (the two rebins and the
metrics, whose distance gate is `physics.distance_gate`), `rl.policy_update`
and `rl.model_update`, a `device.*` record each a replay. The counter
`rl_reward` counts the rewards computed, one a step.

As the JAX package, the sampled action is detached (standard REINFORCE):
the reference differentiates log_prob through an rsample, which cancels
the gradient identically.

`noise` [B, 1] is an argument of `rl_step`: the JAX step draws it from its
PRNG key, which torch cannot reproduce. `make_rl_train_step` draws it from
the state's `torch.Generator` (on the model's device; `RLTrainer` seeds it
with `seed`) outside the program, one draw a step, the stream the eager
trainer drew, and hands it in as an input: the graph holds no draw.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..models.alpha_policy import AlphaPolicy, apply_action
from ..models.swin_wnet import SwinWNet
from ..ops.norms import denormalize_piecewise, ensure_2ch, normalize_piecewise
from ..ops.resize import bilinear_downscale_half
from ..physics.device_metrics import diffraction_metrics_device
from ..physics.qwrapper import Qwrapper, d_centers_hr
from ..core.graphs import Program
from ..utils.profiling import Counter, device_span, span
from .freeze import AdamW, masked_adamw
from .trainers import TrainState, compute_dtype_of


REWARDS = Counter("rl_reward")


def rl_preprocess(model: SwinWNet, images: torch.Tensor):
    """RL_finetuning_pipline.py:183-191, no gradient: (masked images, norm_lr,
    norm_hr, params_hr, segmentator skips)."""
    with torch.no_grad(), device_span("rl.preprocess"):
        seg, skips = model.segment_1(images)
        seg_images = images * torch.sigmoid(seg.float())
        norm_lr, _ = normalize_piecewise(bilinear_downscale_half(seg_images))
        norm_hr, params_hr = normalize_piecewise(seg_images)
    return seg_images, norm_lr, norm_hr, params_hr, skips


def rl_reward(model: SwinWNet, qwrapper: Qwrapper, norm_lr, skips, alpha, params_hr, seg_images,
              lambda_intensity: float, lambda_peak: float, lambda_shape: float):
    """No-grad rollout and its physical reward (:202-230): (reward [B], the
    metrics' dict, the rollout [B, 1, H, W]). Counted by `rl_reward`."""
    with torch.no_grad():
        with device_span("rl.rollout"):
            sr_out, _ = model.upscale(norm_lr, skips)
            sr_out = apply_action(sr_out.float(), alpha)
            denorm_pred = denormalize_piecewise(sr_out, params_hr)[:, 0:1]
        REWARDS.launches += 1
        with device_span("rl.reward"):
            pred_spec = qwrapper.rebin(denorm_pred)
            true_spec = qwrapper.rebin(seg_images[:, 0:1])
            m = diffraction_metrics_device(pred_spec, true_spec, qwrapper.centers_on(pred_spec.device))
            total = (lambda_intensity * m["Integral Intensity"] + lambda_peak * m["Peak Intensity"]
                     + lambda_shape * m["Shape"])
    return -total, m, denorm_pred


def rl_step(model: SwinWNet, policy: AlphaPolicy, model_opt: AdamW, policy_opt: AdamW,
            qwrapper: Qwrapper, images: torch.Tensor, noise: torch.Tensor, lambda_rec: float = 10.0,
            lambda_intensity: float = 2.0, lambda_peak: float = 1.0,
            lambda_shape: float = 0.5,
            rollout: Optional[Dict[str, torch.Tensor]] = None) -> Dict[str, torch.Tensor]:
    """One REINFORCE step on `images` [B, 1|2, H, W] with `noise` [B, 1],
    both on the model's device; updates the policy and the model in place
    and returns the metrics of `swinwnet_tpu/train/rl.py:137-147` (0-d
    tensors on the device). `rollout`, where given, receives `reward` [B]
    and the rewarded rollout `pred` and masked image `true`, [B, 1, H, W].
    The weights are `make_rl_train_step`'s."""
    images = ensure_2ch(images)
    seg_images, norm_lr, norm_hr, params_hr, skips = rl_preprocess(model, images)

    # ---- policy update (REINFORCE) ----
    mu, std = policy(norm_lr)
    alpha = mu.detach() + std * noise  # sampled action
    log_prob = (-0.5 * ((alpha - mu) / std) ** 2 - torch.log(std) - 0.5 * math.log(2 * math.pi)).sum(1)
    reward, m, pred = rl_reward(model, qwrapper, norm_lr, skips, alpha.detach(), params_hr, seg_images,
                                lambda_intensity, lambda_peak, lambda_shape)
    with device_span("rl.policy_update"):
        policy_loss = -(log_prob * reward).mean()
        policy_opt.zero_grad()
        policy_loss.backward()
        policy_opt.step()

    # ---- supervised model update (:244-258) ----
    with device_span("rl.model_update"):
        sr_out, _ = model.upscale(norm_lr, skips)
        sr_out = apply_action(sr_out.float(), mu.detach())
        rec = torch.mean(torch.abs(sr_out - norm_hr))  # F.l1_loss
        sup_loss = lambda_rec * rec
        model_opt.zero_grad()
        sup_loss.backward()
        model_opt.step()

    alpha = alpha.detach()
    if rollout is not None:
        rollout.update(reward=reward, pred=pred, true=seg_images[:, 0:1])
    return {
        "reward": reward.mean(),
        "rec": rec.detach(),
        "integral": m["Integral Intensity"].mean(),
        "peak": m["Peak Intensity"].mean(),
        "shape": m["Shape"].mean(),
        "alpha_mean": alpha.mean(),
        "alpha_std": alpha.std(unbiased=False),
        "policy_loss": policy_loss.detach(),
        "sup_loss": sup_loss.detach(),
    }


@dataclasses.dataclass(eq=False)
class RLState:
    """The JAX `RLState`: the model's and the policy's `TrainState`s and
    `rng`, the generator the step draws its noise from (the JAX PRNG key);
    `rollout`, the last step's (what `rl_step` fills; None before the
    first)."""

    model: TrainState
    policy: TrainState
    rng: torch.Generator
    rollout: Optional[Dict[str, torch.Tensor]] = None


def _rl_state_tensors(state: RLState, *_):
    """What a step reads and updates in place besides the two modules: both
    optimizers' counts and moments."""
    return [*state.model.opt_state.tensors(), *state.policy.opt_state.tensors()]


def draw_noise(rng: torch.Generator, batch: int, device) -> torch.Tensor:
    """A step's action noise, [batch, 1] standard normal from `rng`."""
    return torch.randn((batch, 1), generator=rng, device=device)


def make_rl_train_step(model: SwinWNet, policy: AlphaPolicy, model_tx: AdamW, policy_tx: AdamW,
                       qwrapper: Qwrapper, lambda_rec: float = 10.0, lambda_intensity: float = 2.0,
                       lambda_peak: float = 1.0, lambda_shape: float = 0.5, compute_dtype=None) -> Callable:
    """One RL step as a program: `step(state, images) -> (state, metrics)`
    with `images` [B, 1|2, H, W] (numpy or a tensor) and the nine metrics
    of `rl_step`. `model_tx` and `policy_tx` are the optimizers the state
    was created with (the updates run on `state.model.opt_state` and
    `state.policy.opt_state`); `compute_dtype` (None: the model's own) is
    the JAX `_with_compute_dtype`, under which the forwards and both
    backwards run. The state is updated in place and returned."""
    lambdas = dict(lambda_rec=lambda_rec, lambda_intensity=lambda_intensity, lambda_peak=lambda_peak,
                   lambda_shape=lambda_shape)

    def run(state: RLState, images, noise):
        rollout: Dict[str, torch.Tensor] = {}
        with compute_dtype_of(model, compute_dtype):
            metrics = rl_step(model, policy, state.model.opt_state, state.policy.opt_state, qwrapper, images, noise,
                              **lambdas, rollout=rollout)
        return metrics, rollout

    program = Program(run, modules=(model, policy), state=_rl_state_tensors)

    def step(state: RLState, images):
        with span("train.step"):
            with span("train.batch"):
                device = next(model.parameters()).device
                images = torch.as_tensor(images).to(device=device, dtype=torch.float32)
                noise = draw_noise(state.rng, images.shape[0], device)
            metrics, state.rollout = program(state, images, noise)
            return state, metrics

    return step


class RLTrainer:
    """Epoch loop mirroring the reference API (RL_finetuning_pipline.py:272-307),
    in place on `model` and `policy`, on the model's device. `train_loader`
    is any iterable of image batches (or of tuples whose first item is one)."""

    def __init__(
        self,
        model: SwinWNet,
        policy: AlphaPolicy,
        train_loader,
        d_centers=d_centers_hr,
        num_epochs: int = 100,
        lambda_rec: float = 10.0,
        lambda_intensity: float = 2.0,
        lambda_peak: float = 1.0,
        lambda_shape: float = 0.5,
        policy_lr: float = 1e-4,
        model_lr: float = 1e-5,
        compute_dtype=None,
        seed: int = 0,
        verbose: bool = True,
    ):
        self.model, self.policy = model, policy
        self.train_loader = train_loader
        self.num_epochs = num_epochs
        self.compute_dtype = compute_dtype
        self.verbose = verbose
        self.device = next(model.parameters()).device
        self.qwrapper = Qwrapper(fixed_centers=np.asarray(d_centers), device=self.device)
        self.lambdas = dict(lambda_rec=lambda_rec, lambda_intensity=lambda_intensity, lambda_peak=lambda_peak,
                            lambda_shape=lambda_shape)
        # reference optimizers: Adam 1e-4 policy / 1e-5 model (:118-125)
        policy_tx = AdamW(policy.parameters(), policy_lr, weight_decay=0.0)
        model_tx = masked_adamw(model, "rl", model_lr, weight_decay=0.0)
        self.state = RLState(model=TrainState.create(model, model_tx), policy=TrainState.create(policy, policy_tx),
                             rng=torch.Generator(device=self.device).manual_seed(seed))
        self._step = make_rl_train_step(model, policy, model_tx, policy_tx, self.qwrapper, **self.lambdas,
                                        compute_dtype=compute_dtype)
        self.history = []

    @property
    def policy_opt(self) -> AdamW:
        return self.state.policy.opt_state

    @property
    def model_opt(self) -> AdamW:
        return self.state.model.opt_state

    def train_step(self, images) -> Dict[str, torch.Tensor]:
        """One RL step on a numpy or tensor batch, through the step program;
        noise from the state's generator."""
        self.state, metrics = self._step(self.state, images)
        return metrics

    def train_epoch(self) -> Dict[str, float]:
        agg: Dict[str, float] = {}
        n = 0
        for batch in self.train_loader:
            images = batch[0] if isinstance(batch, (tuple, list)) else batch
            for k, v in self.train_step(images).items():
                agg[k] = agg.get(k, 0.0) + float(v)
            n += 1
        return {k: v / max(n, 1) for k, v in agg.items()}

    def fit(self):
        for epoch in range(self.num_epochs):
            metrics = self.train_epoch()
            self.history.append(metrics)
            if self.verbose:
                print(
                    f"Epoch [{epoch + 1}/{self.num_epochs}] "
                    + " ".join(f"{k}={v:.4f}" for k, v in metrics.items())
                )
        return self.history
