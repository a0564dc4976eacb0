"""REINFORCE fine-tune entry: `swinwnet_tpu_torch.train.RLTrainer.train_step`
(one `make_rl_train_step` program: the frozen segmentator's preprocess, the
policy's sampled action, the no-grad rollout and its on-card physics
reward, the policy's Adam and the "rl" subset's AdamW), built as
`recipes/rl_run.py` builds it, with the configuration's constants.

The comparison (`loops/rl_steps.py`) reads the first steps' sampled
actions, the timed step's own per-sample rewards against the plain reward
of its own rollouts (`rollout`), the first gradients (the optimizers' first
moments after one step) and the trained leaves after the first steps of the
model and of the policy, and the port's physics on the reference's own data
(`physics_reward`).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..yardstick import ref_swinwnet_rl, reference
from .wnet_inference import load
from .wnet_stage3_trainer import change_norms, first_grad_norms


class Program:
    def __init__(self, config: dict, traffic: dict, state_dict: Dict[str, torch.Tensor], device):
        from swinwnet_tpu_torch.models import AlphaPolicy, SwinWNet
        from swinwnet_tpu_torch.train import RLTrainer

        model = SwinWNet(
            patch_size=config["patch_size"], in_chans=config["in_chans"], error_matrix=config["error_matrix"],
            embed_dim=config["embed_dim"], depths=config["depths"], num_heads=config["num_heads"],
            window_size=config["window_size"], mlp_ratio=config["mlp_ratio"], dtype="float32",
            fused_blocks=config["fused_blocks"], attn_chunk=config["attn_chunk"], remat=config["remat"],
            device=device)
        load(model, {k: v for k, v in state_dict.items() if not k.startswith("policy.")})
        policy = AlphaPolicy(device=device)
        policy.load_state_dict({k[len("policy."):]: v for k, v in state_dict.items() if k.startswith("policy.")})
        self.model = model
        self.trainer = RLTrainer(
            model, policy, (), d_centers=np.linspace(*config["d_centers"]), policy_lr=config["policy_lr"],
            model_lr=config["model_lr"], compute_dtype=config["dtype"], verbose=False,
            **{k: float(config[k]) for k in ref_swinwnet_rl.LAMBDAS})
        self.names = {id(p): n for n, p in model.named_parameters()}
        self.names.update({id(p): "policy." + n for n, p in policy.named_parameters()})

    def seed_noise(self, seed: int) -> None:
        self.trainer.state.rng.manual_seed(seed)

    def step(self, images) -> Dict[str, torch.Tensor]:
        return self.trainer.train_step(images)

    def rollout(self) -> Dict[str, torch.Tensor]:
        """The last step's rollout, as its graph computed it: `reward` [B]
        and the rewarded `pred` and masked `true` images [B, 1, H, W]."""
        rollout = getattr(self.trainer.state, "rollout", None)
        if rollout is None:
            raise RuntimeError("the trainer keeps no rollout of its steps, so its reward cannot be checked")
        return rollout

    def first_grad_norms(self) -> Dict[str, Dict[str, float]]:
        return {side: first_grad_norms(self.names, opt.params, opt.m, opt.b1)
                for side, opt in (("model", self.trainer.model_opt), ("policy", self.trainer.policy_opt))}

    def change_norms(self, start: Dict[str, torch.Tensor]) -> Dict[str, float]:
        policy = {n: t for n, t in start.items() if n.startswith("policy.")}
        out = change_norms(self.model, {n: t for n, t in start.items() if n not in policy})
        moved = change_norms(self.trainer.policy, {n[len("policy."):]: t for n, t in policy.items()}) if policy else {}
        out.update({"policy." + n: v for n, v in moved.items()})
        return out


class Reference:
    """The reference's fine-tune: float32 (or, as the control, float8
    products) with TF32 off, its noise drawn as the program's trainer draws
    it, and the plain reward."""

    def __init__(self, config: dict, traffic: dict, state_dict: Dict[str, torch.Tensor], device, fp8: bool = False):
        self.model = reference.build(config, device, fp8=fp8)
        self.model.load_state_dict(state_dict)
        self.device = torch.device(device)
        self.rl = ref_swinwnet_rl.RLStep(self.model, config)
        self.rng = torch.Generator(device=self.device)

    def seed_noise(self, seed: int) -> None:
        self.rng.manual_seed(seed)

    def step(self, images, reward: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """One step; `reward`, where given, weighs the policy's update (see
        `ref_swinwnet_rl.RLStep.step`)."""
        images = torch.as_tensor(images).to(self.device, torch.float32)
        noise = torch.randn((images.shape[0], 1), generator=self.rng, device=self.device)
        return {k: torch.tensor(v) for k, v in self.rl.step(images, noise, reward).items()}

    def rollout(self) -> Dict[str, torch.Tensor]:
        """The last step's reward of its own rollout and that rollout (the
        program's `rollout`, for the control in the program's place)."""
        pred, true = self.rl.rollouts[-1]
        return {"reward": self.rl.last_reward, "pred": pred, "true": true}

    def first_grad_norms(self) -> Dict[str, Dict[str, float]]:
        names = {id(p): n for n, p in self.model.named_parameters()}
        return {side: first_grad_norms(names, opt.params, opt.m, opt.b1)
                for side, opt in (("model", self.rl.model_opt), ("policy", self.rl.policy_opt))}

    def change_norms(self, start: Dict[str, torch.Tensor]) -> Dict[str, float]:
        return change_norms(self.model, start)


def Control(config: dict, traffic: dict, state_dict: Dict[str, torch.Tensor], device) -> Reference:
    """The reference with float8 products, in the program's place."""
    return Reference(config, traffic, state_dict, device, fp8=True)


def physics_reward(config: dict, pred: torch.Tensor, true: torch.Tensor, centers: np.ndarray) -> torch.Tensor:
    """The port's reward of rollouts `pred` against masked images `true`,
    each [B, 1, H, W] on the card, on the grid of bin centres `centers`:
    its `Qwrapper.rebin` and `diffraction_metrics_device`, which the step's
    graph runs."""
    from swinwnet_tpu_torch.physics import Qwrapper
    from swinwnet_tpu_torch.physics.device_metrics import diffraction_metrics_device

    q = Qwrapper(fixed_centers=centers, device=pred.device)
    m = diffraction_metrics_device(q.rebin(pred), q.rebin(true), q.centers_on(pred.device))
    return -(config["lambda_intensity"] * m["Integral Intensity"] + config["lambda_peak"] * m["Peak Intensity"]
             + config["lambda_shape"] * m["Shape"])
