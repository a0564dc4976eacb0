"""Image-quality metrics: confusion-matrix segmentation scores, PSNR, SSIM
(port of `swinwnet_tpu/evalharness/image_metrics.py`).

Ports of the reference helpers (tests.py:12-73) plus torchmetrics-compatible
PSNR/SSIM (PeakSignalNoiseRatio / StructuralSimilarityIndexMeasure with
data_range=1.0, gaussian kernel 11 / sigma 1.5 — tests.py:176-177). The
batched forms (`segmentation_metrics_batch`, `psnr_per_sample`,
`ssim_per_sample`) give one score a sample from one pass over the batch on
its device, in place of the reference's per-sample loop.
"""

from __future__ import annotations

import functools
from typing import Dict

import numpy as np
import torch

from ..core.device import full_fp32
from ..ops.conv import conv2d

METRIC_NAMES = ("PixelAccuracy", "IoU", "Dice", "Precision", "Recall")


def binarize_prediction(pred_probs: torch.Tensor, threshold: float = 0.5) -> torch.Tensor:
    """tests.py:12-16."""
    return (pred_probs >= threshold).to(torch.uint8)


def _counts(pred: torch.Tensor, gt: torch.Tensor, dims):
    """(TP, TN, FP, FN) as fp32 counts of bool maps, summed over `dims`."""
    return tuple(torch.sum(a & b, dim=dims).float() for a, b in
                 ((pred, gt), (~pred, ~gt), (pred, ~gt), (~pred, gt)))


def confusion_matrix_binary(pred_bin: torch.Tensor, gt_bin: torch.Tensor):
    """tests.py:18-30. Reduces over ALL axes (whole sample or whole batch,
    matching how the reference flattens)."""
    return _counts(pred_bin.reshape(-1).bool(), gt_bin.reshape(-1).bool(), 0)


def _scores(TP, TN, FP, FN, eps=1e-8) -> Dict[str, torch.Tensor]:
    return {
        "PixelAccuracy": (TP + TN) / (TP + TN + FP + FN + eps),
        "IoU": TP / (TP + FP + FN + eps),
        "Dice": (2 * TP) / (2 * TP + FP + FN + eps),
        "Precision": TP / (TP + FP + eps),
        "Recall": TP / (TP + FN + eps),
    }


def compute_all_metrics(pred_probs: torch.Tensor, gt_mask: torch.Tensor, threshold: float = 0.5):
    """Metric dict of one sample (tests.py:61-75)."""
    TP, TN, FP, FN = confusion_matrix_binary(binarize_prediction(pred_probs, threshold), gt_mask.to(torch.uint8))
    return _scores(TP, TN, FP, FN)


def segmentation_metrics_batch(pred_probs: torch.Tensor, gt_mask: torch.Tensor, threshold: float = 0.5):
    """[B, 1, H, W] probabilities + masks -> dict of [B] per-sample scores,
    counted over the batch at once."""
    pred = pred_probs >= threshold
    gt = gt_mask.to(torch.uint8).bool()
    return _scores(*_counts(pred, gt, tuple(range(1, pred.dim()))))


# ---------------------------------------------------------------------------
# PSNR / SSIM (torchmetrics-compatible)
# ---------------------------------------------------------------------------


def psnr_per_sample(pred: torch.Tensor, target: torch.Tensor, data_range: float = 1.0) -> torch.Tensor:
    """[B] PSNR of each sample of [B, ...]: 10 log10(range^2 / mse) over its
    elements."""
    diff = pred.float() - target.float()
    mse = torch.mean(torch.square(diff).reshape(len(diff), -1), dim=1)
    return 10.0 * torch.log10(data_range ** 2 / torch.clamp(mse, min=1e-20))


def psnr(pred: torch.Tensor, target: torch.Tensor, data_range: float = 1.0) -> torch.Tensor:
    """10 log10(range^2 / mse) over all elements (torchmetrics default)."""
    return psnr_per_sample(pred.reshape(1, -1), target.reshape(1, -1), data_range)[0]


@functools.lru_cache(maxsize=4)
def _gaussian_kernel(kernel_size: int, sigma: float) -> np.ndarray:
    coords = np.arange(kernel_size, dtype=np.float64) - (kernel_size - 1) / 2.0
    g = np.exp(-(coords ** 2) / (2 * sigma ** 2))
    g /= g.sum()
    return np.outer(g, g).astype(np.float32)


def _ssim_map(pred, target, data_range, kernel_size, sigma, k1, k2) -> torch.Tensor:
    """The [B, C, h, w] SSIM map over the VALID region."""
    pred, target = torch.broadcast_tensors(pred.float(), target.float())
    B, C, H, W = pred.shape
    kern = torch.from_numpy(_gaussian_kernel(kernel_size, sigma)).to(pred.device)[None, None]
    # the five local means as one depthwise VALID convolution with the shared kernel
    maps = torch.stack([pred, target, pred * pred, target * target, pred * target])
    with full_fp32():
        blurred = conv2d(maps.reshape(5 * B * C, 1, H, W), kern)
    mu_p, mu_t, mu_pp, mu_tt, mu_pt = blurred.reshape(5, B, C, *blurred.shape[2:])
    c1, c2 = (k1 * data_range) ** 2, (k2 * data_range) ** 2
    sigma_p = mu_pp - mu_p * mu_p
    sigma_t = mu_tt - mu_t * mu_t
    sigma_pt = mu_pt - mu_p * mu_t
    num = (2 * mu_p * mu_t + c1) * (2 * sigma_pt + c2)
    den = (mu_p ** 2 + mu_t ** 2 + c1) * (sigma_p + sigma_t + c2)
    return num / den


def ssim_per_sample(pred: torch.Tensor, target: torch.Tensor, data_range: float = 1.0, kernel_size: int = 11,
                    sigma: float = 1.5, k1: float = 0.01, k2: float = 0.03) -> torch.Tensor:
    """[B] SSIM of each sample of [B, C, H, W]: the mean of its valid map."""
    return _ssim_map(pred, target, data_range, kernel_size, sigma, k1, k2).mean(dim=(1, 2, 3))


def ssim(pred: torch.Tensor, target: torch.Tensor, data_range: float = 1.0, kernel_size: int = 11,
         sigma: float = 1.5, k1: float = 0.01, k2: float = 0.03) -> torch.Tensor:
    """Structural similarity, torchmetrics defaults (gaussian 11x11 sigma 1.5,
    k1=0.01, k2=0.03, mean over the valid SSIM map)."""
    return torch.mean(_ssim_map(pred, target, data_range, kernel_size, sigma, k1, k2))
