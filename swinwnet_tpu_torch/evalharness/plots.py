"""Metric distribution plots (reference: tests.py:103-151
`plot_metric_distributions` — histograms of the d-space physical metrics with
mean/median/p95 annotations); a copy of
`swinwnet_tpu/evalharness/plots.py`. matplotlib-only (no seaborn dependency); import
is lazy so headless metric runs never touch a display stack.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from .harness import calculate_statistics


def plot_metric_distributions(
    all_metrics: Dict[str, np.ndarray],
    save_path: Optional[str] = None,
    bins: int = 40,
    show: bool = False,
):
    """all_metrics: {'integral': [...], 'peak': [...], 'shape': [...]} ->
    3-panel histogram figure; saved to `save_path` when given."""
    import matplotlib

    if not show:
        matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    titles = {
        "integral": "Integral intensity divergence",
        "peak": "Peak intensity divergence",
        "shape": "Peak shape divergence (W1)",
    }
    keys = [k for k in ("integral", "peak", "shape") if k in all_metrics]
    fig, axes = plt.subplots(1, len(keys), figsize=(5 * len(keys), 4))
    if len(keys) == 1:
        axes = [axes]

    for ax, key in zip(axes, keys):
        data = np.asarray(all_metrics[key], dtype=float)
        data = data[np.isfinite(data)]
        ax.hist(data, bins=bins, color="#4477aa", alpha=0.85)
        ax.set_title(titles.get(key, key))
        if data.size:
            stats = {
                "mean": float(np.mean(data)),
                "median": float(np.median(data)),
                "p95": float(np.percentile(data, 95)),
            }
            ax.text(
                0.02,
                0.98,
                f"mean={stats['mean']:.3g}\nmed ={stats['median']:.3g}\np95 ={stats['p95']:.3g}",
                transform=ax.transAxes,
                ha="left",
                va="top",
                bbox=dict(boxstyle="round", facecolor="white", alpha=0.8),
            )
        calculate_statistics(data, key, verbose=False)

    fig.tight_layout()
    if save_path:
        fig.savefig(save_path, dpi=120)
    if show:
        plt.show()
    return fig
