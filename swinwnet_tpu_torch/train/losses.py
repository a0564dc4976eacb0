"""Supervised losses (port of `swinwnet_tpu/train/losses.py`).

Segmentation losses take logits [B, 1, H, W] and float targets; SR losses
are plain regressions. The registries keep the reference's loss names.
`ssim_loss` takes its SSIM from the eval harness
(`evalharness/image_metrics.py`), as the JAX package's does.
"""

from __future__ import annotations

import torch


def bce_with_logits(logits, target, reduction: str = "mean"):
    """Numerically stable BCE with logits."""
    target = target.to(logits.dtype)
    loss = torch.clamp(logits, min=0) - logits * target + torch.log1p(torch.exp(-torch.abs(logits)))
    if reduction == "mean":
        return loss.mean()
    if reduction == "sum":
        return loss.sum()
    return loss


def dice_loss(pred_logits, target, eps: float = 1e-6):
    pred = torch.sigmoid(pred_logits)
    target = target.to(pred.dtype)
    intersection = (pred * target).sum(dim=(1, 2, 3))
    union = pred.sum(dim=(1, 2, 3)) + target.sum(dim=(1, 2, 3))
    dice = (2.0 * intersection + eps) / (union + eps)
    return 1.0 - dice.mean()


def tversky_loss(pred_logits, target, alpha: float = 0.5, beta: float = 0.5, eps: float = 1e-6):
    pred = torch.sigmoid(pred_logits)
    target = target.to(pred.dtype)
    TP = (pred * target).sum(dim=(1, 2, 3))
    FP = (pred * (1 - target)).sum(dim=(1, 2, 3))
    FN = ((1 - pred) * target).sum(dim=(1, 2, 3))
    tversky = (TP + eps) / (TP + alpha * FP + beta * FN + eps)
    return 1.0 - tversky.mean()


def focal_tversky_loss(pred_logits, target, alpha: float = 0.5, beta: float = 0.5, gamma: float = 0.75):
    """1 - tversky_score ** gamma."""
    t = 1.0 - tversky_loss(pred_logits, target, alpha, beta)
    return 1.0 - t ** gamma


def focal_bce(logits, target, alpha: float = 0.25, gamma: float = 2.0, reduction: str = "mean"):
    target = target.to(logits.dtype)
    bce = bce_with_logits(logits, target, reduction="none")
    pred_prob = torch.sigmoid(logits)
    p_t = target * pred_prob + (1 - target) * (1 - pred_prob)
    loss = alpha * (1 - p_t) ** gamma * bce
    if reduction == "mean":
        return loss.mean()
    if reduction == "sum":
        return loss.sum()
    return loss


def combined_loss(logits, target, boundary_weight_map=None, w_bce: float = 1.0, w_dice: float = 1.0):
    """BCE + Dice with optional per-pixel boundary weights."""
    bce = bce_with_logits(logits, target, reduction="none")
    if boundary_weight_map is not None:
        bce = (bce * boundary_weight_map).mean()
    else:
        bce = bce.mean()
    return w_bce * bce + w_dice * dice_loss(logits, target)


def mse_loss(pred, target):
    return torch.mean(torch.square(pred - target))


def l1_loss(pred, target):
    return torch.mean(torch.abs(pred - target))


def smooth_l1_loss(pred, target, beta: float = 1.0):
    d = torch.abs(pred - target)
    return torch.mean(torch.where(d < beta, 0.5 * d * d / beta, d - 0.5 * beta))


def ssim_loss(pred, target, data_range: float = 1.0):
    """1 - SSIM on normalized patterns clamped to [0, 1]. Clamping zeroes the
    gradient outside [0, 1]; pair it with a pixel loss for coverage there."""
    from ..evalharness.image_metrics import ssim

    return 1.0 - ssim(torch.clamp(pred, 0.0, 1.0), torch.clamp(target, 0.0, 1.0), data_range=data_range)


def smooth_l1_ssim_loss(pred, target, ssim_weight: float = 0.5, beta: float = 1.0):
    return smooth_l1_loss(pred, target, beta) + ssim_weight * ssim_loss(pred, target)


_SEG_LOSSES = {
    "CombinedLoss": combined_loss,
    "DiceLoss": dice_loss,
    "TverskyLoss": tversky_loss,
    "FocalTverskyLoss": focal_tversky_loss,
    "FocalBCE": focal_bce,
}

_SR_LOSSES = {
    "MSELoss": mse_loss,
    "L1Loss": l1_loss,
    "SmoothL1Loss": smooth_l1_loss,
    "SSIMLoss": ssim_loss,
    "SmoothL1SSIMLoss": smooth_l1_ssim_loss,
}


def get_segmentation_loss(name: str):
    if name not in _SEG_LOSSES:
        raise KeyError(f"unknown segmentation loss {name!r}; options: {sorted(_SEG_LOSSES)}")
    return _SEG_LOSSES[name]


def get_upscaler_loss(name: str):
    if name not in _SR_LOSSES:
        raise KeyError(f"unknown upscaler loss {name!r}; options: {sorted(_SR_LOSSES)}")
    return _SR_LOSSES[name]
