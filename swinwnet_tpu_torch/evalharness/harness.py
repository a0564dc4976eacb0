"""Evaluation harness reproducing the reference's `MetricsCalculator`
(port of `swinwnet_tpu/evalharness/harness.py`; reference tests.py:153-475):
segmentation confusion metrics at thresholds 0.25/0.50/0.75 on LR and HR
maps, PSNR/SSIM on the SR output (summary / diffraction-only / error-only
channels), and d-space physical metrics (HR 1241-bin grid for predictions
vs LR 832-bin grid for targets).

Each batch runs on the model's device: the 8-stage pipeline (through
`make_inference_fn`, a CUDA graph per batch shape on the card, as the JAX
harness jit-compiles it) or the SR branch, every per-sample score of the
batch computed there at once and brought to the host in one copy. The
physics rebins the device tensors on
the device (`physics.DiffractionMetricsCalculator`); its peak finding and
matching are the published host specification. Results come back as plain
python structures, writable in the published `results/*.json` schema
(`write_results_json`).
"""

from __future__ import annotations

import json
from typing import Dict, Optional

import numpy as np
import torch

from ..models.alpha_policy import AlphaPolicy, apply_action
from ..models.swin_wnet import SwinWNet
from ..ops.norms import (
    denormalize_piecewise,
    denormalize_piecewise_notebook,
    ensure_2ch,
    normalize_piecewise,
    normalize_piecewise_notebook,
)
from ..ops.resize import bilinear_downscale_half, nearest_exact_resize
from ..physics import DiffractionMetricsCalculator, d_centers_hr, d_centers_lr
from ..pipelines.inference import make_inference_fn
from .image_metrics import METRIC_NAMES, psnr_per_sample, segmentation_metrics_batch, ssim_per_sample

THRESHOLDS = (0.25, 0.5, 0.75)
# CalculateUpscalerMetrics' sections and the channels each scores
SR_SECTIONS = (("Summary Metrics", slice(None)), ("Only Diffraction Metrics", slice(0, 1)),
               ("Only Error Matrix Metrics", slice(1, 2)))


def calculate_statistics(data, metric_name: str, verbose: bool = True):
    """tests.py:78-91 (ddof=1 std)."""
    data = np.asarray(data)
    mean_val = float(np.mean(data)) if data.size else float("nan")
    std_val = float(np.std(data, ddof=1)) if data.size > 1 else float("nan")
    if verbose:
        print(f"{metric_name}: mean={mean_val:.4f} std={std_val:.4f} n={data.size}")
    return mean_val, std_val


def write_results_json(path: str, payload: Dict):
    """Dump metric arrays in the published results/*.json schema."""

    def tolist(x):
        if isinstance(x, dict):
            return {k: tolist(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return [tolist(v) for v in x]
        if hasattr(x, "tolist"):
            return x.tolist()
        return x

    with open(path, "w") as f:
        json.dump(tolist(payload), f)


class MetricsCalculator:
    """Drives the model over a loader of numpy (images, masks) batches and
    aggregates segmentation / SR / physical metric distributions, on the
    model's device."""

    def __init__(
        self,
        model: SwinWNet,
        val_loader,
        verbose: bool = True,
        policy: Optional[AlphaPolicy] = None,
        norm_convention: str = "reference",
    ):
        """`policy`: optional trained AlphaPolicy — when given, the SR branch
        applies the deterministic action mu after `upscale`, matching the RL
        inference pipeline (RL_Inference_Pipline.py:113-121), so post-RL
        metrics run through the same harness as the supervised ones.

        `norm_convention`: "reference" (default) = the tests.py /
        ST_Inference_Pipline norm pair (exact inverse; what the models are
        trained with); "notebook" = the Physycal_metrics_test.ipynb pair
        (/log1p(1) norm + plain expm1 denorm — intentionally non-inverse; see
        ops.norms.normalize_piecewise_notebook). The four published
        *_physycal_metrics_extended.json baselines were produced under the
        notebook convention, so physical-metric comparisons against them must
        use it; segmentation and PSNR/SSIM baselines came through tests.py
        and keep the reference convention either way."""
        if norm_convention == "notebook":
            self._norm, self._denorm = normalize_piecewise_notebook, denormalize_piecewise_notebook
        elif norm_convention == "reference":
            self._norm, self._denorm = normalize_piecewise, denormalize_piecewise
        else:
            raise ValueError(f"unknown norm_convention {norm_convention!r}")
        self.model = model.eval()
        self.val_loader = val_loader
        self.verbose = verbose
        self.policy = None if policy is None else policy.eval()
        self.device = next(model.parameters()).device
        self._infer = make_inference_fn(model)

        self.d_centers_lr = d_centers_lr
        self.d_centers_hr = d_centers_hr
        self.physical = DiffractionMetricsCalculator(
            fixed_centers_pred=self.d_centers_hr, fixed_centers_true=self.d_centers_lr, device=self.device
        )

    def _on_device(self, array) -> torch.Tensor:
        return torch.as_tensor(array).to(device=self.device, dtype=torch.float32)

    @torch.inference_mode()
    def sr_forward(self, images):
        """The SR branch shared by the upscaler and physical evals
        (tests.py:326-347): segment_1 and sigmoid, the mask, the x0.5
        downscale, the norm of the downscaled and of the full image,
        upscale, the policy's mu when given, the denorm. Returns
        (images_downscaled, norm_images, sr_out, denorm_sr_out)."""
        images = ensure_2ch(self._on_device(images))
        seg, skips_seg = self.model.segment_1(images)
        images = images * torch.sigmoid(seg)
        images_downscaled = bilinear_downscale_half(images)
        norm_downscaled, _ = self._norm(images_downscaled)
        norm_images, params_images = self._norm(images)
        sr_out, _ = self.model.upscale(norm_downscaled, skips_seg)
        if self.policy is not None:
            mu, _std = self.policy(norm_downscaled)
            sr_out = apply_action(sr_out, mu)
        return images_downscaled, norm_images, sr_out, self._denorm(sr_out, params_images)

    # ------------------------------------------------------------------
    @torch.inference_mode()
    def CalculateSegmentationMetrics(self) -> Dict:
        """tests.py:212-305. Returns {'Low Res'/'High Res': {'<t> thrashold':
        [per-sample dicts]}} (schema-compatible, including the key spelling)."""
        acc = {res: {t: [] for t in THRESHOLDS} for res in ("lr", "hr")}

        for images, masks in self.val_loader:
            masks = self._on_device(masks)
            masks = masks[:, None] if masks.ndim == 3 else masks
            stages = self._infer(self._on_device(images))
            masks_up = nearest_exact_resize(masks, masks.shape[-2] * 2, masks.shape[-1] * 2)
            # [res, threshold, metric, sample], one copy to the host
            scores = torch.stack([
                torch.stack([torch.stack(list(segmentation_metrics_batch(seg, gt, threshold=t).values()))
                             for t in THRESHOLDS])
                for seg, gt in ((stages["seg_map_lr"], masks), (stages["seg_map_hr"], masks_up))
            ]).cpu().numpy()
            for r, res in enumerate(("lr", "hr")):
                for i, t in enumerate(THRESHOLDS):
                    acc[res][t] += [dict(zip(METRIC_NAMES, map(float, s))) for s in scores[r, i].T]

        all_metrics = {
            "Low Res": {f"{t:.2f} thrashold": acc["lr"][t] for t in THRESHOLDS},
            "High Res": {f"{t:.2f} thrashold": acc["hr"][t] for t in THRESHOLDS},
        }
        if self.verbose:
            for res_name, key in (("Low Res", "lr"), ("High Res", "hr")):
                print(f"\n== Segmentation Metrics {res_name} ==")
                for name in METRIC_NAMES:
                    for t in THRESHOLDS:
                        arr = np.array([m[name] for m in acc[key][t]])
                        calculate_statistics(arr, f"{t:.2f} threshold {name}")
        return all_metrics

    # ------------------------------------------------------------------
    def CalculateUpscalerMetrics(self) -> Dict:
        """tests.py:307-399: PSNR/SSIM on clamped [0,1] normalized SR output
        vs normalized GT, per sample, for all/ch0/ch1 channels."""
        out = {name: {"PSNR": [], "SSIM": []} for name, _ in SR_SECTIONS}

        for images, _ in self.val_loader:
            _, norm_images, sr_out, _ = self.sr_forward(images)
            gt = torch.clamp(norm_images, 0, 1)
            pred = torch.clamp(sr_out, 0, 1)
            sections = SR_SECTIONS if gt.shape[1] > 1 else SR_SECTIONS[:2]
            # [section, PSNR|SSIM, sample], one copy to the host
            scores = torch.stack([
                torch.stack([psnr_per_sample(gt[:, ch], pred[:, ch]), ssim_per_sample(gt[:, ch], pred[:, ch])])
                for _, ch in sections
            ]).cpu().numpy()
            for (name, _), s in zip(sections, scores):
                out[name]["PSNR"] += [float(v) for v in s[0]]
                out[name]["SSIM"] += [float(v) for v in s[1]]

        if self.verbose:
            for section, vals in out.items():
                print(f"\n== {section} ==")
                for k, arr in vals.items():
                    calculate_statistics(arr, k)
        return out

    # ------------------------------------------------------------------
    def CalculatePhysycalMetrics(self) -> Dict:
        """tests.py:402-475: d-space metrics of the denormalized SR output
        (HR grid, scale=True) vs the x0.5-downscaled masked input (LR grid)."""
        all_metrics = {"integral": [], "peak": [], "shape": []}

        for images, _ in self.val_loader:
            images_downscaled, _, _, denorm_sr_out = self.sr_forward(images)
            allm = self.physical(
                batch_pred_2d=denorm_sr_out[:, 0:1],
                batch_true_2d=images_downscaled[:, 0:1],
                peak_params_pred={"scale": True},
                peak_params_true={"scale": False},
                tol=0.05,
            )
            all_metrics["integral"].append(np.asarray(allm["Integral Intensity"]))
            all_metrics["peak"].append(np.asarray(allm["Peak Intensity"]))
            all_metrics["shape"].append(np.asarray(allm["Shape"]))

        for k in all_metrics:
            all_metrics[k] = (
                np.concatenate(all_metrics[k], axis=0) if all_metrics[k] else np.array([])
            )
        if self.verbose:
            calculate_statistics(all_metrics["integral"], "Integral intensity")
            calculate_statistics(all_metrics["peak"], "Peak intensity")
            calculate_statistics(all_metrics["shape"], "Peak shape")
        return all_metrics
