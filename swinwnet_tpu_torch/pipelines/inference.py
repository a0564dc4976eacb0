"""The 8-stage SwinWNet inference pipeline (port of
`swinwnet_tpu/pipelines/inference.py`).

ensure_2ch -> segment_1 -> mask -> normalize -> upscale -> denormalize ->
segment_2 -> mask, on the model's device, as the three stages of
`pipelines/split.py`. `make_inference_fn` makes the whole pipeline one
program (`core.graphs`: on the card a CUDA graph captured once per input
shape and replayed, as the JAX package jit-compiles it), and
`SwinWNetInference` calls through it, keeping every stage as an attribute
as the reference wrapper does. A call is a `serve.request` span, the batch's
move to the card a `serve.to_device` span inside it (`utils.profiling`).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..core.graphs import Program
from ..models.swin_wnet import SwinWNet
from ..ops.norms import denormalize_piecewise, ensure_2ch, normalize_piecewise
from ..utils.profiling import span
from .split import inference_stages, make_split_inference_fn

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


def make_inference_fn(model: SwinWNet, donate: bool = False) -> Program:
    """`fn(images) -> stages dict` for a [B, 1|2, H, W] batch on the model's
    device: `inference_stages` as one program. The model owns its weights,
    so there is no `variables` argument (the JAX `fn(variables, images)`);
    `donate` is the JAX flag, kept for the signature (see `Program`)."""
    return Program(functools.partial(inference_stages, model), modules=(model,), donate=donate)


class SwinWNetInference:
    """Call with a batch (numpy or tensor, fp32 on the model's device), read
    the stage attributes. Returns `images_masked_hr`.

    The batch runs through `make_inference_fn`, or with `split=True` (the
    JAX constructor's flag) through `make_split_inference_fn`'s three
    programs; the two routes run the same operations."""

    def __init__(self, model: SwinWNet, split: bool = False):
        self.model = model.eval()
        self.device = next(model.parameters()).device
        self._fn = make_split_inference_fn(model) if split else make_inference_fn(model)
        self._reset_outputs()

    def _reset_outputs(self):
        for name in STAGE_NAMES:
            setattr(self, name, None)

    # static utils kept on the class for API parity
    ensure_2ch = staticmethod(ensure_2ch)
    normalize_piecewise = staticmethod(normalize_piecewise)
    denormalize_piecewise = staticmethod(denormalize_piecewise)

    def __call__(self, images) -> torch.Tensor:
        with span("serve.request"):
            self._reset_outputs()
            with span("serve.to_device"):
                if isinstance(images, np.ndarray):
                    images = torch.from_numpy(images)
                images = images.to(device=self.device, dtype=torch.float32)
            stages = self._fn(images)
            for name in STAGE_NAMES:
                setattr(self, name, stages[name])
            return self.images_masked_hr
