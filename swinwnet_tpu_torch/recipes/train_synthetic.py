"""End-to-end workflow on synthetic data: generate -> the three supervised
stages -> the RL fine-tune -> evaluation -> results JSONs, a plot (with
matplotlib) and a checkpoint (port of `examples/train_synthetic.py`).

A miniature of the reference's whole lifecycle (the dataset generation
notebooks -> Supervised_train_full_pipline -> RL_finetuning_pipline ->
tests.py metrics -> results/*.json) that runs in minutes on one card;
`--tiny` for a small model at 40x40, `--device cpu` on the CPU.

    python -m swinwnet_tpu_torch.recipes.train_synthetic --tiny --epochs 2 --out runs/demo
"""

from __future__ import annotations

import argparse
import os

import torch

from ..core.device import resolve_device
from ..data.generation import synthesize_dataset
from ..data.loaders import ArrayLoader
from ..data.native_loader import NativeBatcher
from ..data.noise import make_train_noise_augment
from ..evalharness import MetricsCalculator, plot_metric_distributions, write_results_json
from ..models import AlphaPolicy
from ..train import RLTrainer, SwinWNetTrainingPipeline
from .quality_run import TINY, new_model, save_model

FULL = dict(in_chans=1, error_matrix=True)  # the model's defaults: the published width


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--tiny", action="store_true", help="tiny model + 40x40 patterns")
    parser.add_argument("--samples", type=int, default=16)
    parser.add_argument("--epochs", type=int, default=2)
    parser.add_argument("--batch", type=int, default=4)
    parser.add_argument("--rl-epochs", type=int, default=1)
    parser.add_argument("--loader", choices=("array", "native"), default="array",
                        help="input pipeline: the numpy ArrayLoader or the C++ prefetching NativeBatcher")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    parser.add_argument("--fused-blocks", action="store_true",
                        help="route the levels the gate admits through the fused Swin-block kernel")
    parser.add_argument("--out", default="runs/synthetic")
    return parser.parse_args(argv)


def main(argv=None):
    """Returns (the supervised histories, the RL history)."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    os.makedirs(args.out, exist_ok=True)

    arch, (H, W) = (TINY, (40, 40)) if args.tiny else (FULL, (250, 480))
    model = new_model(arch, device, args.fused_blocks)

    print("generating synthetic dataset...")
    images, masks = synthesize_dataset(args.samples, H=H, W=W, seed=0)
    split = max(args.samples * 3 // 4, 1)
    # the train-time additive background covers the published eval
    # protocol's N(100, 20) injection (see recipes.quality_run)
    if args.loader == "native":
        train_loader = NativeBatcher(
            images[:split], masks[:split], batch_size=args.batch, shuffle=True,
            add_noise=True, noise_mu_range=(0.0, 150.0),
        )
        val_loader = NativeBatcher(images[split:], masks[split:], batch_size=args.batch, shuffle=False)
    else:
        train_loader = ArrayLoader(
            images[:split], masks[:split], batch_size=args.batch, shuffle=True,
            augment=make_train_noise_augment(),
        )
        val_loader = ArrayLoader(images[split:], masks[split:], batch_size=args.batch)

    print("3-stage supervised training...")
    _, histories = SwinWNetTrainingPipeline(
        model, train_loader, val_loader, seg_epochs=args.epochs, sr_epochs=args.epochs,
        full_epochs=args.epochs, warmup_epochs=1,
    ).run()

    print("RL fine-tuning...")
    policy = AlphaPolicy(device=device, generator=torch.Generator().manual_seed(1))
    rl_history = RLTrainer(model, policy, train_loader, num_epochs=args.rl_epochs).fit()

    print("evaluation...")
    calc = MetricsCalculator(model, val_loader, verbose=True)
    seg = calc.CalculateSegmentationMetrics()
    sr = calc.CalculateUpscalerMetrics()
    phys = calc.CalculatePhysycalMetrics()

    write_results_json(
        os.path.join(args.out, "segmentation_metrics.json"),
        {
            "metrics_25": seg["Low Res"]["0.25 thrashold"],
            "metrics_50": seg["Low Res"]["0.50 thrashold"],
            "metrics_75": seg["Low Res"]["0.75 thrashold"],
        },
    )
    write_results_json(
        os.path.join(args.out, "upscaling_metrics.json"),
        {"PSNRs": sr["Summary Metrics"]["PSNR"], "SSIMs": sr["Summary Metrics"]["SSIM"]},
    )
    write_results_json(
        os.path.join(args.out, "physycal_metrics.json"),
        {
            "Integral Intensity losses": phys["integral"],
            "Peak Intensity losses": phys["peak"],
            "Shape_losses": phys["shape"],
        },
    )
    try:
        plot_metric_distributions(phys, save_path=os.path.join(args.out, "physical_metrics.png"))
    except ImportError as e:  # matplotlib is optional: the metrics are written above
        print(f"no plot written: {e}")
    save_model(os.path.join(args.out, "checkpoints"), model, arch)
    print(f"artifacts written to {args.out}")
    return histories, rl_history


if __name__ == "__main__":
    main()
