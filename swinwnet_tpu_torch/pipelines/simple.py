"""Single-tower inference pipelines (port of `swinwnet_tpu/pipelines/simple.py`;
BASELINE configs #1 and #2).

* `make_segmentation_fn(SwinUNet)`: [B, 1|2, H, W] -> sigmoid probability
  map (checkpoint: SwinUnet_binary_segmentation_diffraction.pth).
* `make_sr_fn(SwinUNetSR)`: masked pattern -> 2x super-resolved pattern
  (checkpoint: SwinUnetSR_upscaler_for_segmented_diffraction.pth), with the
  reference's normalize -> upscale -> denormalize wrapping.

Each returns a callable that takes numpy or a tensor, moves it to the
model's device and runs the pipeline there under `torch.inference_mode` as
one program (`core.graphs`: on the card a CUDA graph captured once per
input shape and replayed, as the JAX package jit-compiles it); the program
is the callable's `program` attribute. A call is a `serve.request` span,
the move to the device a `serve.to_device` span inside it
(`utils.profiling`).
"""

from __future__ import annotations

import torch

from ..core.graphs import Program
from ..models.swin_unet import SwinUNet, SwinUNetSR
from ..ops.norms import denormalize_piecewise, normalize_piecewise
from ..utils.profiling import span


def _on_device(model: torch.nn.Module, images) -> torch.Tensor:
    return torch.as_tensor(images).to(device=next(model.parameters()).device, dtype=torch.float32)


def _program_of(model: torch.nn.Module, run):
    """`run(images)` as a program over `model`, behind a callable that
    takes numpy or a tensor."""
    program = Program(torch.inference_mode()(run), modules=(model,))

    def fn(images) -> torch.Tensor:
        with span("serve.request"):
            with span("serve.to_device"):
                images = _on_device(model, images)
            return program(images)

    fn.program = program
    return fn


def make_segmentation_fn(model: SwinUNet):
    model.eval()

    def segment(images):
        return torch.sigmoid(model(images))

    return _program_of(model, segment)


def make_sr_fn(model: SwinUNetSR, normalize: bool = True):
    model.eval()

    def run(images):
        if normalize:
            norm, params = normalize_piecewise(images)
            return denormalize_piecewise(model(norm), params)
        return model(images)

    return _program_of(model, run)
