#!/usr/bin/env python3
"""The unfused levels' window attention kernel against its bound and the
plain chain it replaces, at SwinWNet's four unfused shapes, on one CUDA card.

    python3 scripts/window_attention_timing.py [--batch 64] [--reps 20] [--tree DIR]

For each shape (C, heads) with its window count at the 250 x 480 detector
and the given batch, in bf16 under `torch.inference_mode`, the mean of
`--reps` launches between CUDA events after three warm ones:

* `forward_ms`: `WindowAttention.forward` with `attn_chunk` 8192, what a
  serving block runs (the qkv linear, the attention, the output projection);
* where the tree has the kernel (swinwnet_tpu_torch/ops/window_attention.py):
  `kernel_ms`, the kernel from the qkv linear's output, and `plain_ms`, the
  plain chain from it over chunks of 8192 windows, as `_attend` runs it;
* `bound_ms`: qkv read once and the heads' output written once, 8 bytes a
  token-channel, over 3.35 TB/s (H100 SXM).

With --tree it imports swinwnet_tpu_torch from that checkout instead (for
example an unpacked parent commit, which has no kernel: its forward runs the
plain chain), so that two versions are timed on one card, one after the
other. Prints the card's name and power limit, then one JSON line a shape.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import torch

PEAK_BYTES_S = 3.35e12
TOKENS = 25
CHUNK = 8192
# (C, heads, token grid of the level at the 250 x 480 detector): encoder L3
# and the bottleneck, encoder L2, decoder stage 0, decoder stage 1
SHAPES = [(384, 24, (16, 30)), (192, 12, (32, 60)), (384, 12, (32, 60)), (192, 6, (63, 120))]


def mean_ms(fn, reps: int) -> float:
    for _ in range(3):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--tree", default=None, help="a checkout whose swinwnet_tpu_torch to time")
    args = ap.parse_args()
    root = Path(args.tree).resolve() if args.tree else Path(__file__).resolve().parent.parent
    sys.path.insert(0, str(root))
    from swinwnet_tpu_torch.models.layers import WindowAttention, linear

    if not torch.cuda.is_available():
        print("window_attention_timing: no CUDA device", file=sys.stderr)
        return 1
    has_kernel = importlib.util.find_spec("swinwnet_tpu_torch.ops.window_attention") is not None
    if has_kernel:
        from swinwnet_tpu_torch.ops.window_attention import window_attention, window_attention_plain
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}; tree: {root}; kernel: {has_kernel}", flush=True)
    dev, dt = torch.device("cuda"), torch.bfloat16
    torch.manual_seed(0)
    for C, nH, (h, w) in SHAPES:
        windows = args.batch * (-(-h // 5)) * (-(-w // 5))
        m = WindowAttention(C, 5, nH, True, dt, attn_chunk=CHUNK).to(dev)
        with torch.no_grad():
            m.relative_position_bias_table.normal_(0, 0.5)
        x = torch.randn(windows, TOKENS, C, device=dev).to(dt)
        line = {"C": C, "heads": nH, "windows": windows,
                "bound_ms": windows * TOKENS * C * 8 / PEAK_BYTES_S * 1e3}
        with torch.inference_mode():
            line["forward_ms"] = mean_ms(lambda: m(x), args.reps)
            if has_kernel:
                qkv, bias = linear(x, m.qkv, dt), m.rel_bias()
                kernel = lambda: window_attention(qkv, bias, nH, dt)
                plain = lambda: torch.cat([window_attention_plain(c, bias, nH, dt) for c in qkv.split(CHUNK)])
                k1, p1, p2, k2 = (mean_ms(f, args.reps) for f in (kernel, plain, plain, kernel))
                line.update(kernel_ms=(k1 + k2) / 2, plain_ms=(p1 + p2) / 2)
                line["kernel_x_bound"] = line["kernel_ms"] / line["bound_ms"]
        print(json.dumps({**line, "card": card, "tree": str(root)}), flush=True)
        del m, x
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
