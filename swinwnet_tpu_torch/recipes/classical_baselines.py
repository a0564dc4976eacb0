"""Classical SR baselines through the published physical-metric pipeline
(port of `scripts/classical_baselines.py`; the reference's
Physycal_metrics_test.ipynb cells 14-27). Two weights-free upscalers go
through the metric stack used for the model:

* **bilinear** (cell 22, `results/BilinearInterpolation_..._extended.json`):
  mask -> MaxPool2d(2) -> normalize -> bilinear x2 -> denormalize with the
  HR normalization params -> d-space metrics (pred on the HR 1241-bin grid
  with scale=True, true = the pooled LR on the 832-bin grid);
* **avgpool** (cell 25, `results/AVGPoolin_..._extended.json`): pred = the
  masked HR pattern itself against its MaxPool2d(2) LR (the published file
  says AvgPool, the notebook cell pools with MaxPool2d: mirrored as is).

Both also get the older scalar peak-matching loss (support_files/
Peak_loss.py:161-190 -> `results/AGVpool_peak_losses.json`) through
`physics.legacy.DiffractionPipeline`.

* `--norm notebook` (default): the notebook's normalize divides the log
  branch by log1p(1) while its denormalize does not invert that
  (`ops.norms.normalize_piecewise_notebook`); `--norm exact` keeps the
  trainers' self-consistent pair.
* `--data real` (default when the reference datasets are present): the six
  real patterns and their labeled masks; `--data synthetic` the quality
  run's synthetic eval crystals.
* `--mask gt` masks with the labeled or ground-truth binary masks; `--mask
  ckpt` with the soft sigmoid masks of a checkpoint of our own training
  (`--ckpt`, a directory or a file, as the quality run writes it), as the
  published runs masked with the trained model's.

    python -m swinwnet_tpu_torch.recipes.classical_baselines --out CLASSICAL_r04_real
    python -m swinwnet_tpu_torch.recipes.classical_baselines --data synthetic --out CLASSICAL_r04_syn

The rebins, the norms and the resize run on `--device` (the card unless
`--device cpu`); the peak finding and matching on the host.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from ..core.device import resolve_device
from ..data.noise import add_eval_noise
from ..data.real import load_real_eval_set, reference_available
from ..evalharness.regression import compare_with_baseline
from ..ops.norms import (
    denormalize_piecewise,
    denormalize_piecewise_notebook,
    ensure_2ch,
    normalize_piecewise,
    normalize_piecewise_notebook,
)
from ..ops.resize import bilinear_resize
from ..physics import DiffractionMetricsCalculator, d_centers_hr, d_centers_lr
from ..physics.legacy import DiffractionPipeline
from .quality_run import DEFAULT_BASELINES, HELD_OUT, load_model, make_crystal_library, render_crystals

PUBLISHED_FILES = {
    "bilinear": "BilinearInterpolation_diffraction_physycal_metrics_extended.json",
    "avgpool": "AVGPoolin_diffraction_physycal_metrics_extended.json",
}


def maxpool2(x: np.ndarray) -> np.ndarray:
    """nn.MaxPool2d(kernel_size=2, stride=2) on [B, C, H, W]."""
    B, C, H, W = x.shape
    return x.reshape(B, C, H // 2, 2, W // 2, 2).max(axis=(3, 5))


def mask_fn(args, eval_masks, device):
    """hr [B, 2, H, W] numpy -> its mask: the checkpoint's sigmoid
    segmentation (`--mask ckpt`, fp32) or the ground truth's."""
    if args.mask != "ckpt":
        return lambda hr: eval_masks[:, None].astype(np.float32)
    if not args.ckpt:
        raise ValueError("--mask ckpt needs --ckpt")
    model, _, _ = load_model(os.path.abspath(args.ckpt), device, args.fused_blocks, attn_chunk=8192)
    model.eval()

    @torch.inference_mode()
    def seg(hr):
        logits, _ = model.segment_1(torch.from_numpy(hr).to(device))
        return torch.sigmoid(logits.float()).cpu().numpy()

    return seg


def bilinear_prediction(hr: np.ndarray, lr: np.ndarray, norm_fn, denorm_fn, device) -> np.ndarray:
    """normalize(lr) -> bilinear x2 to hr's size (half-pixel centers, as
    `jax.image.resize(..., "bilinear")`) -> denormalize with hr's params."""
    norm_lr, _ = norm_fn(torch.from_numpy(lr).to(device))
    _, params_hr = norm_fn(torch.from_numpy(hr).to(device))
    sr = bilinear_resize(norm_lr, hr.shape[2], hr.shape[3])
    return denorm_fn(sr, params_hr).cpu().numpy()


def compare_with_published(vals, ref_path: str) -> dict:
    """Each metric's comparison with the published per-sample distribution:
    the mean band, and where our mean sits inside that distribution."""
    with open(ref_path) as f:
        ref = json.load(f)
    comp = {}
    for ours_key, ref_key in (("Integral Intensity", "Integral Intensity losses"),
                              ("Peak Intensity", "Peak Intensity losses"),
                              ("Shape", "Shape_losses")):
        if ref_key in ref:
            base = np.asarray(ref[ref_key], dtype=np.float64)
            c = compare_with_baseline(np.asarray(vals[ours_key]), base)
            c["percentile_in_published"] = round(float((base <= c["mean_new"]).mean() * 100.0), 1)
            c["within_published_iqr"] = bool(np.percentile(base, 25) <= c["mean_new"] <= np.percentile(base, 75))
            c["within_published_p5_p95"] = bool(
                np.percentile(base, 5) <= c["mean_new"] <= np.percentile(base, 95))
            comp[ours_key] = c
    return comp


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out", default="CLASSICAL_r04")
    p.add_argument("--data", choices=("real", "synthetic"), default=None,
                   help="default: real if the reference datasets are present")
    p.add_argument("--norm", choices=("notebook", "exact"), default="notebook",
                   help="normalize/denormalize convention (see the module docstring)")
    p.add_argument("--height", type=int, default=250)
    p.add_argument("--width", type=int, default=480)
    p.add_argument("--eval-renders-per-crystal", type=int, default=8)
    p.add_argument("--noise-passes", type=int, default=5)
    p.add_argument("--mask", choices=("gt", "ckpt"), default="gt")
    p.add_argument("--ckpt", default=None, help="checkpoint directory or file for --mask ckpt")
    p.add_argument("--baselines", default=DEFAULT_BASELINES)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="where the rebins, norms and resize run (the peak finding is on the host)")
    p.add_argument("--fused-blocks", action="store_true",
                   help="--mask ckpt: route the levels the gate admits through the fused Swin-block kernel")
    return p.parse_args(argv)


def main(argv=None):
    """Returns the summary."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    if args.data is None:
        args.data = "real" if reference_available() else "synthetic"
    if args.norm == "notebook":
        norm_fn, denorm_fn = normalize_piecewise_notebook, denormalize_piecewise_notebook
    else:
        norm_fn, denorm_fn = normalize_piecewise, denormalize_piecewise

    t0 = time.time()
    if args.data == "real":
        eval_images, eval_masks, names = load_real_eval_set()
        data_note = f"real reference patterns ({', '.join(names)}) + labeled masks"
    else:
        lib = make_crystal_library(0, seed=0, device=device)
        eval_images, eval_masks = render_crystals(
            lib, HELD_OUT, args.eval_renders_per_crystal, args.height, args.width, seed=2
        )
        data_note = "synthetic eval crystals (quality_run recipe)"
    print(f"eval set {eval_images.shape} [{args.data}] ({time.time() - t0:.0f}s)")

    mask_of = mask_fn(args, eval_masks, device)
    calc = DiffractionMetricsCalculator(fixed_centers_pred=d_centers_hr, fixed_centers_true=d_centers_lr,
                                        device=device)
    pipe_scalar = DiffractionPipeline(fixed_centers_pred=d_centers_hr, fixed_centers_true=d_centers_lr,
                                      device=device)
    keys = ("Integral Intensity", "Peak Intensity", "Shape", "peak_loss")
    results = {name: {k: [] for k in keys} for name in PUBLISHED_FILES}

    for k in range(args.noise_passes):
        hr = add_eval_noise(eval_images[:, None].astype(np.float32), seed=k)
        hr = ensure_2ch(torch.from_numpy(hr)).numpy()
        hr = hr * mask_of(hr)
        lr = maxpool2(hr)
        denorm_pred = bilinear_prediction(hr, lr, norm_fn, denorm_fn, device)

        # chunks of 8 keep the host peak finding's memory flat
        B = hr.shape[0]
        for lo in range(0, B, 8):
            hi = min(lo + 8, B)
            for name, pred in (("bilinear", denorm_pred[lo:hi, 0:1]), ("avgpool", hr[lo:hi, 0:1])):
                m = calc(pred, lr[lo:hi, 0:1], peak_params_pred={"scale": True},
                         peak_params_true={"scale": False}, tol=0.05)
                for key in keys[:3]:
                    results[name][key].extend(float(x) for x in m[key])
                for i in range(hi - lo):
                    results[name]["peak_loss"].append(float(pipe_scalar(
                        pred[i:i + 1], lr[lo + i:lo + i + 1, 0:1],
                        peak_params_pred={"scale": True}, peak_params_true={"scale": False},
                    )))
        print(f"noise pass {k + 1}/{args.noise_passes} done ({time.time() - t0:.0f}s)")

    # the notebook-schema JSONs and the summary
    summary = {
        "run": args.out,
        "protocol": "Physycal_metrics_test.ipynb cells 14-27 (mask -> MaxPool2d -> "
                    "bilinear x2 / identity -> d-space metrics, "
                    f"{args.noise_passes} noise passes)",
        "data": data_note,
        "norm_convention": args.norm,
        "mask_source": args.mask,
        "n_samples": len(results["bilinear"]["Shape"]),
        "baselines": {},
        "note": (
            "published runs: 240 real test patterns (stats 1e7..5e8, pulse 10..300us) "
            "x5 noise passes with trained-model soft masks; this run substitutes the "
            "locally available data/masks (see 'data'/'mask_source'), so strict mean "
            "bands are complemented by each metric's percentile inside the published "
            "per-sample distribution"
        ),
    }
    for name, vals in results.items():
        with open(f"{args.out}_{name}_physical_metrics.json", "w") as f:
            json.dump({
                "Integral Intensity losses": vals["Integral Intensity"],
                "Peak Intensity losses": vals["Peak Intensity"],
                "Shape_losses": vals["Shape"],
            }, f, indent=4)
        with open(f"{args.out}_{name}_peak_losses.json", "w") as f:
            json.dump({"peak_losses": vals["peak_loss"]}, f, indent=4)
        entry = {m: [float(np.mean(vals[m])), float(np.std(vals[m], ddof=1))] for m in keys}
        ref_path = os.path.join(args.baselines, PUBLISHED_FILES[name])
        if os.path.exists(ref_path):
            entry["vs_published"] = compare_with_published(vals, ref_path)
        summary["baselines"][name] = entry

    with open(f"{args.out}.json", "w") as f:
        json.dump(summary, f, indent=1)
    print(json.dumps(summary["baselines"], indent=1, default=str)[:2500])
    print(f"wrote {args.out}.json (+4 metric files) in {(time.time() - t0) / 60:.1f} min")
    return summary


if __name__ == "__main__":
    main()
