#!/usr/bin/env python3
"""Per-launch times of the Swin-block kernel at the SR head's two levels
(C = 24 on the 250 x 480 token grid, C = 12 on 500 x 960, 3 heads) at a
serving batch, on one CUDA card.

    python3 scripts/swin_block_narrow_timing.py [--batch 64] [--plain] [--tree DIR]

Times `fused_swin_block_cst` on the token-major windows the models pass
(bf16; both grids tile by 5, so no pad mask) with CUDA events over many
launches (chip_smoke.py's `cuda_ms`), beside its bound (chip_smoke.py's
`block_cost`: each activation read once and written once, the weights
once, at 3.35 TB/s; the operations at 989 TFLOP/s stay below it) and, with
--plain, `swin_block_plain`. With --tree it imports chip_smoke and
swinwnet_tpu_torch from that checkout instead (for example an unpacked
parent commit), so that two versions of the kernel are timed on one card,
one call after the other. Prints one line a level and one JSON line with the
numbers, the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--plain", action="store_true", help="also time swin_block_plain (tens of GB at B = 64)")
    ap.add_argument("--tree", default=None, help="a checkout whose chip_smoke and swinwnet_tpu_torch to time")
    args = ap.parse_args()
    root = Path(args.tree).resolve() if args.tree else Path(__file__).resolve().parent.parent
    sys.path.insert(0, str(root))
    import chip_smoke as cs
    from swinwnet_tpu_torch.ops import swin_block as sb

    if not torch.cuda.is_available():
        print("swin_block_narrow_timing: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    bf16, gen = torch.bfloat16, torch.Generator().manual_seed(0)
    rows = []
    for name, C, nH, grid, _ in (lv for lv in cs.LEVELS if lv[0].startswith("SR level")):
        xt, a, mask = cs.level_args(C, nH, grid, args.batch, bf16, gen)
        x, Wt = xt.permute(2, 1, 0), xt.shape[0]
        ms = cs.cuda_ms(lambda: sb.fused_swin_block_cst(x, *a, num_heads=nH, pad_mask=mask), args.reps)
        flops, nbytes = cs.block_cost(C, nH, Wt, bf16, mask is not None)
        bound = max(flops / cs.PEAK_OPS[bf16], nbytes / cs.HBM_BPS) * 1e3
        row = {"level": name, "C": C, "nH": nH, "windows": Wt, "body": sb.kernel_plan(C, nH, bf16).body,
               "kernel_ms": ms, "bound_ms": bound, "times_bound": ms / bound}
        if args.plain:
            row["plain_ms"] = cs.cuda_ms(lambda: sb.swin_block_plain(x, *a, num_heads=nH, pad_mask=mask), 2)
        rows.append(row)
        print(f"  {name:11s} C={C:2d} nH={nH} Wt={Wt:8d} body {row['body']}: kernel {ms:.4f} ms, bound "
              f"{bound:.4f} ms ({ms / bound:.1f}x)" + (f", plain {row['plain_ms']:.2f} ms" if args.plain else ""))
        del xt, x, a
        torch.cuda.empty_cache()
    print(json.dumps({"tree": str(root), "card": smi, "batch": args.batch, "levels": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
