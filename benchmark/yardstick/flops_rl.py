"""The operations of one image through a REINFORCE step, counted on the
plain reference (`ref_swinwnet_rl`) with `FlopCounterMode` on the meta
device: products and convolutions of the preprocess, the policy's forward
and backward, the no-grad rollout and the supervised update's forward and
backward. The reward (a rebin and peak search, no products) and remat's
recompute are not counted.
"""

from __future__ import annotations

import torch

from . import reference
from .flops import _count
from .ref_swinwnet_rl import RLStep


def rl_flops_per_image(config: dict) -> int:
    model = reference.build(config, "meta")
    rl = RLStep(model, config)
    x = torch.zeros(1, config["in_chans"], config["height"], config["width"], device="meta")

    def step():
        seg_images, norm_lr, norm_hr, params_hr, skips = rl.preprocess(x)
        mu, std = model.policy(norm_lr)
        alpha = (mu + std).detach()
        rl.rollout(norm_lr, skips, alpha, params_hr)
        rl.policy_update(mu, std, alpha, torch.zeros(1, device="meta"))
        rl.model_update(norm_lr, skips, mu, norm_hr)

    return _count(step)
