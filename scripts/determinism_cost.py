#!/usr/bin/env python3
"""What the deterministic backward costs, on one CUDA card.

    python3 scripts/determinism_cost.py

Every convolution of the models runs its backward through
swinwnet_tpu_torch/ops/conv.py, so that two runs of a training step give the
same bits: the input's gradient from cuDNN restricted to deterministic
algorithms, the weight's from one product a kernel tap. This script times,
at the published width with random weights from a seed, one fp32 training
step of each stage at [8, 2, 250, 480] with fused_blocks and fused_deep
(chip_smoke.py's training path), as shipped against the same step through
F.conv2d (cuDNN free to pick its algorithms), in turns (shipped, free, free,
shipped), each the median of four steps after a warm one; then the
upscaling head's 3x3 convolution (12 channels, B=8) alone at its two sizes:
the weight's gradient by cuDNN's own choice, by cuDNN's deterministic
algorithm and by the products, and the shipped forward and backward. Prints
the card's name and power limit first.
"""

from __future__ import annotations

import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from swinwnet_tpu_torch.core.device import full_fp32  # noqa: E402
from swinwnet_tpu_torch.models import SwinWNet  # noqa: E402
from swinwnet_tpu_torch.models import layers as layers_mod  # noqa: E402
from swinwnet_tpu_torch.ops import conv as conv_mod  # noqa: E402
from swinwnet_tpu_torch.train import FullModelTrainer, SegmentatorTrainer, UpscalerTrainer  # noqa: E402

B, H, W = 8, 250, 480
SHIPPED = layers_mod.det_conv2d
ROUTES = {"shipped": SHIPPED, "F.conv2d": F.conv2d}


def step_ms(kind, batch, n=4):
    model = SwinWNet(in_chans=1, error_matrix=True, fused_blocks=True, fused_deep=True, device="cuda",
                     generator=torch.Generator().manual_seed(0)).train()
    cls = {"stage1": SegmentatorTrainer, "stage2": UpscalerTrainer}.get(kind, FullModelTrainer)
    trainer = cls(model, [batch], num_epochs=1, warmup_epochs=1, verbose=False)
    if cls is FullModelTrainer:
        run = lambda: trainer.train_step(*batch, even=kind == "stage3_even")
    else:
        run = lambda: trainer.train_step(*batch)
    run()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def cuda_ms(fn, reps=10):
    fn()
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def conv_times(hw):
    """ms of the weight's gradient three ways, and of the shipped forward
    and backward, for the 3x3 at [B, 12, *hw]."""
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(B, 12, *hw, generator=gen).cuda()
    w = torch.randn(12, 12, 3, 3, generator=gen).cuda()
    b = torch.randn(12, generator=gen).cuda()
    g = torch.randn(B, 12, *hw, generator=gen).cuda()
    wgrad = lambda: torch.ops.aten.convolution_backward(g, x, w, [12], [1, 1], [1, 1], [1, 1], False, [0, 0], 1,
                                                        [False, True, True])
    xr, wr, br = (t.clone().requires_grad_(True) for t in (x, w, b))
    with full_fp32():
        free = cuda_ms(wgrad)
        with conv_mod.deterministic_cudnn():
            deterministic = cuda_ms(wgrad)
        taps = cuda_ms(lambda: conv_mod.weight_grad_taps(x, g, (3, 3), (1, 1), (1, 1), (1, 1)))
    shipped = cuda_ms(lambda: conv_mod.conv2d(xr, wr, br, padding=1).backward(g))
    return free, deterministic, taps, shipped


def main() -> int:
    if not torch.cuda.is_available():
        print("determinism_cost: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    rng = np.random.default_rng(0)
    batch = (rng.uniform(0, 1e3, (B, 2, H, W)).astype(np.float32),
             (rng.uniform(size=(B, H, W)) > 0.85).astype(np.float32))
    order = ["shipped", "F.conv2d", "F.conv2d", "shipped"]
    try:
        for kind in ("stage1", "stage2", "stage3_even", "stage3_odd"):
            for name in order:
                layers_mod.det_conv2d = ROUTES[name]
                print(f"fp32 {kind:11s} step, B={B}, convolutions {name:9s} {step_ms(kind, batch):8.1f} ms", flush=True)
    finally:
        layers_mod.det_conv2d = SHIPPED
    for hw in ((500, 960), (250, 480)):
        free, deterministic, taps, shipped = conv_times(hw)
        print(f"the upscaling head's 3x3 at [{B}, 12, {hw[0]}, {hw[1]}]: the weight's gradient by cuDNN's choice "
              f"{free:.3f} ms, by its deterministic algorithm {deterministic:.3f} ms, by the products {taps:.3f} ms; "
              f"the shipped forward and backward {shipped:.3f} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
