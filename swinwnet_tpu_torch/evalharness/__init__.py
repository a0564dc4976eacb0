"""The evaluation harness: the reference's segmentation, upscaler and
physical metrics over a loader, the image metrics they use, the published
results schema and the golden-baseline comparison."""

from .harness import MetricsCalculator, calculate_statistics, write_results_json
from .image_metrics import (
    binarize_prediction,
    compute_all_metrics,
    confusion_matrix_binary,
    psnr,
    psnr_per_sample,
    segmentation_metrics_batch,
    ssim,
    ssim_per_sample,
)
from .plots import plot_metric_distributions
from .regression import PUBLISHED, compare_with_baseline, load_baseline_arrays

__all__ = [
    "binarize_prediction",
    "confusion_matrix_binary",
    "compute_all_metrics",
    "segmentation_metrics_batch",
    "psnr",
    "psnr_per_sample",
    "ssim",
    "ssim_per_sample",
    "MetricsCalculator",
    "write_results_json",
    "calculate_statistics",
    "load_baseline_arrays",
    "compare_with_baseline",
    "PUBLISHED",
    "plot_metric_distributions",
]
