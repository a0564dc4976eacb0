#!/usr/bin/env python3
"""Where a CTA of the port's fused Swin-block kernel spends its cycles, on one
CUDA card.

    python3 scripts/swin_block_phases.py

Builds swinwnet_tpu_torch/ops/csrc/swin_block.cu with -DSWIN_BLOCK_PHASES, in
which thread 0 of every CTA adds the clock64() cycles of each phase to a
device array, and runs the row-major entry (`fused_swin_block`) in fp32 at
the six shapes a training step with fused_deep gives it at B = 8, weights
stored [out, in] as the models pass them. Per shape it prints the kernel's
time, its plan and the mean cycles per CTA of each phase, the products'
cycles split into copy start, copy wait, barrier, FMA loop and epilogue, and
the FFMA rate inside the loops. The counters slow the kernel by a few
percent; chip_smoke.py times the kernel without them.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as cs  # noqa: E402
from swinwnet_tpu_torch.ops import swin_block as sb  # noqa: E402

PHASES = ["load", "LN1", "qkv", "attention", "proj", "residual", "LN2", "fc1", "fc2", "store"]
IN_PRODUCTS = ["copy start", "copy wait", "barrier", "FMA loop", "epilogue"]


def main() -> int:
    if not torch.cuda.is_available():
        print("swin_block_phases: no CUDA device", file=sys.stderr)
        return 1
    lib = sb.bind(sb.build(defines=("SWIN_BLOCK_PHASES",)))
    lib.swin_block_phases.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.swin_block_phases.restype = ctypes.c_int
    sb._lib = lib  # the wrappers launch the instrumented build
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"cycles per CTA by phase, fp32, B={cs.TRAIN_B}, on {smi}")
    gen = torch.Generator().manual_seed(cs.SEED)
    counters = (ctypes.c_ulonglong * 16)()
    for name, C, nH, grid, _ in cs.ROW_LEVELS:
        xt, args, mask_nw = cs.level_args(C, nH, grid, cs.TRAIN_B, torch.float32, gen)
        args = cs.in_out_args(args)
        x = xt.reshape(-1, C)
        mask = None if mask_nw is None else mask_nw.t().reshape(-1, 1)
        run = lambda: sb.fused_swin_block(x, *args, num_heads=nH, pad_mask=mask)
        ms = cs.cuda_ms(run, 10)
        if lib.swin_block_phases(None, 1):
            raise SystemExit("could not clear the phase counters")
        run()
        if lib.swin_block_phases(counters, 0):
            raise SystemExit("could not read the phase counters")
        plan = sb.kernel_plan(C, nH, torch.float32)
        Wt = xt.shape[0]
        ctas = -(-Wt // plan.WB)
        per_cta = [c / ctas for c in counters]
        total = sum(per_cta[:10])
        # FFMAs one warp executes in the loops of a CTA: 12 C^2 per row, over the
        # threads that hold a register tile; two such warps share a scheduler
        tiles = 5 * plan.WB * (plan.OT // plan.CN)
        ffma_per_thread = 25 * plan.WB * 12 * C * C / tiles
        print(f"  {name:13s} C={C:3d} nH={nH:2d} Wt={Wt:5d} {ms:.4f} ms  WB={plan.WB} G={plan.G} tile "
              f"{plan.KC}x{plan.OT} {plan.smem_bytes} B shared, {ctas} CTAs, {total:.0f} cycles a CTA")
        print("    " + "  ".join(f"{n} {100 * c / total:.1f}%" for n, c in zip(PHASES, per_cta)))
        print("    in the products: " + "  ".join(f"{n} {100 * c / total:.1f}%" for n, c in zip(IN_PRODUCTS, per_cta[10:])))
        print(f"    FFMA per cycle and warp inside the loops {ffma_per_thread / per_cta[13]:.3f} "
              f"({plan.threads // 128} warps a scheduler)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
