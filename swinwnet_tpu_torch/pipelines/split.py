"""The 8-stage pipeline as three stages (port of
`swinwnet_tpu/pipelines/split.py`).

The JAX package compiles segment_1, upscale and segment_2 as three
executables chained by a thin Python function, to cut peak compile memory,
and so that a partial pipeline (segmentation-only serving is `stage_a`
alone) reuses them. Here the stages are plain functions, and the 8-stage
`inference_stages` is their composition; `make_split_inference_fn` makes
each stage a program (`core.graphs`: a CUDA graph on the card) and chains
the three. The split route and the single route run the same operations and
give the same stage tensors, bit for bit.
"""

from __future__ import annotations

import functools
from typing import Dict

import torch

from ..core.graphs import Program
from ..models.swin_wnet import SwinWNet
from ..ops.norms import denormalize_piecewise, ensure_2ch, normalize_piecewise


@torch.inference_mode()
def stage_a(model: SwinWNet, images: torch.Tensor):
    """ensure_2ch -> segment_1 -> mask -> normalize: (images, seg_map_lr,
    images_masked_lr, norm, params_norm, skips_seg)."""
    images = ensure_2ch(images)
    seg, skips_seg = model.segment_1(images)
    seg_map_lr = torch.sigmoid(seg)
    images_masked_lr = images * seg_map_lr
    norm, params_norm = normalize_piecewise(images_masked_lr)
    return images, seg_map_lr, images_masked_lr, norm, params_norm, skips_seg


@torch.inference_mode()
def stage_b(model: SwinWNet, norm: torch.Tensor, params_norm, skips_seg):
    """upscale -> denormalize: (upscaled_norm, upscaled_denorm, skips_sr)."""
    upscaled_norm, skips_sr = model.upscale(norm, skips_seg)
    return upscaled_norm, denormalize_piecewise(upscaled_norm, params_norm), skips_sr


@torch.inference_mode()
def stage_c(model: SwinWNet, upscaled_denorm: torch.Tensor, skips_sr):
    """segment_2 -> mask: (seg_map_hr, images_masked_hr)."""
    seg_high, _ = model.segment_2(upscaled_denorm, skips_sr)
    seg_map_hr = torch.sigmoid(seg_high)
    return seg_map_hr, upscaled_denorm * seg_map_hr


def inference_stages(model: SwinWNet, images: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The 8 stages for a [B, 1|2, H, W] batch on the model's device: the
    three stages in turn."""
    images, seg_map_lr, images_masked_lr, norm, params_norm, skips_seg = stage_a(model, images)
    upscaled_norm, upscaled_denorm, skips_sr = stage_b(model, norm, params_norm, skips_seg)
    seg_map_hr, images_masked_hr = stage_c(model, upscaled_denorm, skips_sr)
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


def make_split_inference_fn(model: SwinWNet):
    """`fn(images) -> stages dict` for a [B, 1|2, H, W] batch on the model's
    device, three programs chained: `fn.stage_a(images)`,
    `fn.stage_b(norm, params_norm, skips_seg)` and
    `fn.stage_c(upscaled_denorm, skips_sr)`, each a program of one stage
    bound to `model` (a CUDA graph per input shape on the card)."""
    a, b, c = (Program(functools.partial(stage, model), modules=(model,)) for stage in (stage_a, stage_b, stage_c))

    def fn(images: torch.Tensor) -> Dict[str, torch.Tensor]:
        images, seg_map_lr, images_masked_lr, norm, params_norm, skips_seg = a(images)
        upscaled_norm, upscaled_denorm, skips_sr = b(norm, params_norm, skips_seg)
        seg_map_hr, images_masked_hr = c(upscaled_denorm, skips_sr)
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

    fn.stage_a, fn.stage_b, fn.stage_c = a, b, c
    return fn
