"""RL-augmented inference (port of `swinwnet_tpu/pipelines/rl_inference.py`;
reference: RL_Inference_Pipline.py:6-146): the 8-stage pipeline with the
alpha policy's deterministic gain on the SR output.

Stage order (reference :95-145): ensure_2ch -> segment_1 -> mask ->
normalize -> policy(mu) -> upscale -> apply_action -> denormalize ->
segment_2 -> mask, run eagerly on the model's device; `alpha` is an extra
stage.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..models.alpha_policy import AlphaPolicy, apply_action
from ..models.swin_wnet import SwinWNet
from ..ops.norms import denormalize_piecewise, ensure_2ch, normalize_piecewise
from .inference import STAGE_NAMES


@torch.inference_mode()
def rl_inference_stages(model: SwinWNet, policy: AlphaPolicy, images: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The stages and `alpha` for a [B, 1|2, H, W] batch on the model's device."""
    images = ensure_2ch(images)
    seg, skips_seg = model.segment_1(images)
    seg_map_lr = torch.sigmoid(seg)
    images_masked_lr = images * seg_map_lr
    norm, params_norm = normalize_piecewise(images_masked_lr)

    # policy: deterministic action = mu (RL_Inference_Pipline.py:113-116)
    alpha, _ = policy(norm)

    upscaled_norm, skips_sr = model.upscale(norm, skips_seg)
    upscaled_norm = apply_action(upscaled_norm, alpha)
    upscaled_denorm = denormalize_piecewise(upscaled_norm, params_norm)
    seg_high, _ = model.segment_2(upscaled_denorm, skips_sr)
    seg_map_hr = torch.sigmoid(seg_high)
    return {
        "images": images,
        "seg_map_lr": seg_map_lr,
        "images_masked_lr": images_masked_lr,
        "norm": norm,
        "alpha": alpha,
        "upscaled_norm": upscaled_norm,
        "upscaled_denorm": upscaled_denorm,
        "seg_map_hr": seg_map_hr,
        "images_masked_hr": upscaled_denorm * seg_map_hr,
    }


class RLInference:
    """`SwinWNetInference`'s attribute API plus `alpha`: call with a batch
    (numpy or tensor, fp32 on the model's device), read the stages. Returns
    `images_masked_hr`."""

    def __init__(self, model: SwinWNet, policy: AlphaPolicy):
        self.model = model.eval()
        self.policy = policy.eval()
        self.device = next(model.parameters()).device
        self._reset_outputs()

    def _reset_outputs(self):
        for name in STAGE_NAMES + ("alpha",):
            setattr(self, name, None)

    def __call__(self, images) -> torch.Tensor:
        self._reset_outputs()
        if isinstance(images, np.ndarray):
            images = torch.from_numpy(images)
        images = images.to(device=self.device, dtype=torch.float32)
        for name, value in rl_inference_stages(self.model, self.policy, images).items():
            setattr(self, name, value)
        return self.images_masked_hr
