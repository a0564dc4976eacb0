#!/usr/bin/env python3
"""PatchExpanding's shuffle-and-LayerNorm kernel against its bound and the
four passes it replaces, on one CUDA card.

    python3 scripts/expand_norm_timing.py [--batch 64] [--out FILE]

For each width of SwinWNet's expansions (C/2 = 192, 96, 48 in the decoder,
24 and 12 in the SR head), at the token grid it expands at the 250 x 480
detector and the given batch, in bf16: the kernel (swinwnet_tpu_torch/ops/
expand_norm.py) and the plain version (the shuffle's copy, the cast to fp32,
torch's LayerNorm, the cast back: what `PatchExpanding` ran before, and runs
outside `torch.inference_mode`), each the mean of 20 launches between CUDA events after
three warm ones, in turns (kernel, plain, plain, kernel), the two means of
each averaged. The bound is each element read once and written once, 4 bytes
in bf16, over 3.35 TB/s (H100 SXM). Prints the card's name and power limit
first and one JSON line a width; `--out` writes the lines to a file too.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch
from torch import nn

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from swinwnet_tpu_torch.ops.expand_norm import patch_expand_norm, patch_expand_norm_plain  # noqa: E402

GRIDS = {192: (16, 30), 96: (32, 60), 48: (63, 120), 24: (125, 240), 12: (250, 480)}
PEAK_BYTES_S = 3.35e12


def mean_ms(fn, reps: int = 20) -> float:
    for _ in range(3):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(f"card: {card}", flush=True)
    dev, dt = torch.device("cuda"), torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(0)
    lines = []
    for c, (H, W) in GRIDS.items():
        y = torch.randn(args.batch, H, W, 4 * c, device=dev, generator=g).to(dt)
        ln = nn.LayerNorm(c).to(dev)
        kernel = lambda: patch_expand_norm(y, ln, dt)
        plain = lambda: patch_expand_norm_plain(y, ln, dt)
        k1, p1, p2, k2 = mean_ms(kernel), mean_ms(plain), mean_ms(plain), mean_ms(kernel)
        elements = y.numel()
        bound_ms = 2 * elements * y.element_size() / PEAK_BYTES_S * 1e3
        kernel_ms, plain_ms = (k1 + k2) / 2, (p1 + p2) / 2
        line = {"c": c, "grid": [args.batch, H, W], "rows": elements // c, "kernel_ms": kernel_ms,
                "plain_ms": plain_ms, "bound_ms": bound_ms, "share_of_bound": bound_ms / kernel_ms,
                "kernel_TB_s": 2 * elements * y.element_size() / kernel_ms / 1e9, "card": card}
        print(json.dumps(line), flush=True)
        lines.append(line)
        del y
        torch.cuda.empty_cache()
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("".join(json.dumps(x) + "\n" for x in lines))


if __name__ == "__main__":
    main()
