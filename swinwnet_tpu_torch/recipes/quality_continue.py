"""Continue stage-2/3 training from a quality-run checkpoint and run the
published eval protocol again (port of `scripts/quality_continue.py`).

Buys more budget for the SR-facing stages without repeating stage 1: the
quality run's SR PSNR sat ~9 dB below the protocol's noise ceiling on the
same data (normalize(clean*mask) scored against normalize(noisy*mask)
gives 38.08 +- 0.63 dB), so it was limited by training, not by the
protocol. The data recipe and seeds are the quality run's.

    python -m swinwnet_tpu_torch.recipes.quality_continue --ckpt QUALITY_r03_ckpt \\
        --out QUALITY_r03 --sr-epochs 20 --full-epochs 30

Writes `{out}_cont.json`, `{out}_cont_{segmentation,upscaling,physical}
_metrics.json` and the checkpoint `{out}_ckpt_cont`. Runs on the card;
`--device cpu` on the CPU.
"""

from __future__ import annotations

import argparse
import json
import time

from ..core.device import resolve_device
from ..data.loaders import ArrayLoader
from ..data.noise import make_train_noise_augment
from ..train.trainers import FullModelTrainer, UpscalerTrainer
from .quality_run import (
    PUBLISHED,
    PUBLISHED_RUNTIME,
    load_model,
    metric_summaries,
    render_data,
    run_eval_protocol,
    save_model,
    write_metric_files,
)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--ckpt", default="QUALITY_r03_ckpt")
    p.add_argument("--out", default="QUALITY_r03")
    p.add_argument("--height", type=int, default=250)
    p.add_argument("--width", type=int, default=480)
    p.add_argument("--train-crystals", type=int, default=64)
    p.add_argument("--renders-per-crystal", type=int, default=6)
    p.add_argument("--eval-renders-per-crystal", type=int, default=8)
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--sr-epochs", type=int, default=20)
    p.add_argument("--full-epochs", type=int, default=30)
    p.add_argument("--warmup-epochs", type=int, default=3)
    p.add_argument("--noise-passes", type=int, default=5)
    p.add_argument("--sr-loss", default="SmoothL1Loss",
                   help="stage-2/3 reconstruction loss (SmoothL1SSIMLoss adds a structural term)")
    p.add_argument("--compute-dtype", choices=("fp32", "bf16"), default="bf16")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--fused-blocks", action="store_true",
                   help="route the levels the gate admits through the fused Swin-block kernel")
    return p.parse_args(argv)


def main(argv=None):
    """Returns the summary."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    cdtype = "bfloat16" if args.compute_dtype == "bf16" else None
    t_start = time.time()

    _, train_images, train_masks, eval_images, eval_masks = render_data(args, device)
    print(f"train {train_images.shape}, eval {eval_images.shape}")
    train_loader = ArrayLoader(
        train_images, train_masks, batch_size=args.batch, shuffle=True,
        augment=make_train_noise_augment(),
    )
    val_loader = ArrayLoader(
        eval_images, eval_masks, batch_size=args.batch,
        augment=make_train_noise_augment(mu_range=(100.0, 100.0)),
    )
    model, path, tree = load_model(args.ckpt, device, args.fused_blocks, **PUBLISHED_RUNTIME)
    print(f"loaded {path}")

    t0 = time.time()
    if args.sr_epochs:
        print("=== Stage 2 (continue): upscaler ===")
        t2 = UpscalerTrainer(model, train_loader, val_loader, loss=args.sr_loss, num_epochs=args.sr_epochs,
                             warmup_epochs=args.warmup_epochs, compute_dtype=cdtype)
        t2.train()
        t2.release_training_state()
    if args.full_epochs:
        print("=== Stage 3 (continue): joint ===")
        t3 = FullModelTrainer(model, train_loader, val_loader, upscaler_loss=args.sr_loss,
                              num_epochs=args.full_epochs, warmup_epochs=args.warmup_epochs, compute_dtype=cdtype)
        t3.train()
        t3.release_training_state()
    print(f"continuation trained in {(time.time() - t0) / 60:.1f} min")
    save_model(f"{args.out}_ckpt_cont", model, tree.get("model", PUBLISHED))

    # the reference norm pair for all three methods, as the JAX continuation
    seg_all, ups_all, phys_all = run_eval_protocol(model, eval_images, eval_masks, args.batch, args.noise_passes,
                                                   physics_norm="reference")
    summary = {
        "run": f"{args.out} (continuation)",
        "continued_from": path,
        "extra_epochs": {"sr": args.sr_epochs, "full": args.full_epochs},
        "n_eval_samples": int(len(eval_images) * args.noise_passes),
        **metric_summaries(seg_all, ups_all, phys_all),
    }
    with open(f"{args.out}_cont.json", "w") as f:
        json.dump(summary, f, indent=1)
    write_metric_files(f"{args.out}_cont", seg_all, ups_all, phys_all)
    print(f"wrote {args.out}_cont.json (total {(time.time() - t_start) / 60:.1f} min)")
    print(json.dumps(summary["upscaling"], indent=1))
    return summary


if __name__ == "__main__":
    main()
