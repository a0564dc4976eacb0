"""The 8-stage SwinWNet inference pipeline (port of
`swinwnet_tpu/pipelines/inference.py`).

ensure_2ch -> segment_1 -> mask -> normalize -> upscale -> denormalize ->
segment_2 -> mask, run eagerly on the model's device. `SwinWNetInference`
keeps every stage as an attribute, as the reference wrapper does.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..models.swin_wnet import SwinWNet
from ..ops.norms import denormalize_piecewise, ensure_2ch, normalize_piecewise

STAGE_NAMES = (
    "images",
    "seg_map_lr",
    "images_masked_lr",
    "norm",
    "upscaled_norm",
    "upscaled_denorm",
    "seg_map_hr",
    "images_masked_hr",
)


@torch.inference_mode()
def inference_stages(model: SwinWNet, images: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The 8 stages for a [B, 1|2, H, W] batch on the model's device."""
    images = ensure_2ch(images)
    seg, skips_seg = model.segment_1(images)
    seg_map_lr = torch.sigmoid(seg)
    images_masked_lr = images * seg_map_lr
    norm, params_norm = normalize_piecewise(images_masked_lr)
    upscaled_norm, skips_sr = model.upscale(norm, skips_seg)
    upscaled_denorm = denormalize_piecewise(upscaled_norm, params_norm)
    seg_high, _ = model.segment_2(upscaled_denorm, skips_sr)
    seg_map_hr = torch.sigmoid(seg_high)
    images_masked_hr = upscaled_denorm * seg_map_hr
    return {
        "images": images,
        "seg_map_lr": seg_map_lr,
        "images_masked_lr": images_masked_lr,
        "norm": norm,
        "upscaled_norm": upscaled_norm,
        "upscaled_denorm": upscaled_denorm,
        "seg_map_hr": seg_map_hr,
        "images_masked_hr": images_masked_hr,
    }


class SwinWNetInference:
    """Call with a batch (numpy or tensor, fp32 on the model's device), read
    the stage attributes. Returns `images_masked_hr`."""

    def __init__(self, model: SwinWNet):
        self.model = model.eval()
        self.device = next(model.parameters()).device
        self._reset_outputs()

    def _reset_outputs(self):
        for name in STAGE_NAMES:
            setattr(self, name, None)

    def __call__(self, images) -> torch.Tensor:
        self._reset_outputs()
        if isinstance(images, np.ndarray):
            images = torch.from_numpy(images)
        images = images.to(device=self.device, dtype=torch.float32)
        stages = inference_stages(self.model, images)
        for name in STAGE_NAMES:
            setattr(self, name, stages[name])
        return self.images_masked_hr
