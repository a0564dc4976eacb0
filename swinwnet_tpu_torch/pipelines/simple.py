"""Single-tower inference pipelines (port of `swinwnet_tpu/pipelines/simple.py`;
BASELINE configs #1 and #2).

* `make_segmentation_fn(SwinUNet)`: [B, 1|2, H, W] -> sigmoid probability
  map (checkpoint: SwinUnet_binary_segmentation_diffraction.pth).
* `make_sr_fn(SwinUNetSR)`: masked pattern -> 2x super-resolved pattern
  (checkpoint: SwinUnetSR_upscaler_for_segmented_diffraction.pth), with the
  reference's normalize -> upscale -> denormalize wrapping.

Each returns a callable that takes numpy or a tensor and runs under
`torch.inference_mode` on the model's device.
"""

from __future__ import annotations

import torch

from ..models.swin_unet import SwinUNet, SwinUNetSR
from ..ops.norms import denormalize_piecewise, normalize_piecewise


def _on_device(model: torch.nn.Module, images) -> torch.Tensor:
    return torch.as_tensor(images).to(device=next(model.parameters()).device, dtype=torch.float32)


def make_segmentation_fn(model: SwinUNet):
    model.eval()

    @torch.inference_mode()
    def fn(images) -> torch.Tensor:
        return torch.sigmoid(model(_on_device(model, images)))

    return fn


def make_sr_fn(model: SwinUNetSR, normalize: bool = True):
    model.eval()

    @torch.inference_mode()
    def fn(images) -> torch.Tensor:
        images = _on_device(model, images)
        if normalize:
            norm, params = normalize_piecewise(images)
            return denormalize_piecewise(model(norm), params)
        return model(images)

    return fn
