#!/usr/bin/env python3
"""Where a CTA of the port's fused Swin-block kernel spends its cycles, on one
CUDA card.

    python3 scripts/swin_block_phases.py             # row-major, fp32
    python3 scripts/swin_block_phases.py --serving   # and cst and wide, bf16

Builds swinwnet_tpu_torch/ops/csrc/swin_block.cu with -DSWIN_BLOCK_PHASES, in
which thread 0 of every CTA adds the clock64() cycles of each phase to a
device array. Runs the row-major entry (`fused_swin_block`) in fp32 at the
six shapes a training step with fused_deep gives it at B = 8, weights stored
[out, in] as the models pass them; with --serving also the channels-major
entry (`fused_swin_block_cst`) at the five shapes of a bf16 serving call and
the wide entry (`fused_swin_block_wide`) at its four, B = 4, as the models
pass them. Per shape it prints the kernel's time, its plan, its registers
and CTAs an SM (the occupancy calculator), and the mean cycles per window
batch (one batch a CTA, or several for a CTA that walks batches) of each
phase, the products' cycles split into copy start, copy wait, barrier, the
FMA loop and epilogue, and the FFMA rate inside the loops. The counters slow the kernel by a few percent;
chip_smoke.py times the kernel without them. The bf16 launches above C = 24
run the Hopper body, whose counters are its consumer thread 0's phases
(window wait, load + LN1, weight wait, wgmma, epilogues, named-barrier waits,
attention, output staging) and its two producer warps' (waits, stores, TMA
requests), printed per window batch; those at C <= 24 the narrow body, whose
counters are lane 0 of each CTA's first warp (copy wait, rows + LN1, qkv,
scores + softmax, E.V, proj + residual + LN2, MLP, output + store, next
loads), printed per window that warp owns.
"""

from __future__ import annotations

import argparse
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
# the Hopper body's counters (HPHASE in the .cu): consumer thread 0's phases,
# then lane 0 of the window producer warp, then of the weight producer
HOPPER_CONSUMER = ["window wait", "load + LN1", "weight wait", "wgmma", "qkv epilogue",
                   "barriers", "attention", "proj epilogue + LN2", "fc1 epilogue (GELU)", "output staging"]
HOPPER_WINDOW = ["wait for a batch's output", "store", "next load"]
HOPPER_WEIGHT = ["wait for a free slot", "TMA requests"]
# the narrow body's counters: lane 0 of each CTA's first warp, by phase of
# each window it owns (the unit's waits, loads and store counted once a unit)
NARROW = ["copy wait", "rows + LN1", "qkv", "scores + softmax", "E.V", "proj + residual + LN2", "MLP",
          "output + store", "next loads"]


def first_warp_windows(plan, Wt, ctas_sm):
    """Windows the first warp of every CTA of a narrow-body launch owns, summed
    over the grid (as the launcher sizes it)."""
    warps = plan.threads // 32
    units = -(-Wt // plan.WB)
    grid = min(-(-units // warps), ctas_sm * torch.cuda.get_device_properties(0).multi_processor_count)
    return sum(min(plan.WB, Wt - u * plan.WB) for b in range(grid) for u in range(b * warps, units, grid * warps))


def measure(lib, counters, tag, name, run, C, nH, Wt, dtype, round_qkv):
    """Time `run` (one launch of an entry), then read one launch's counters
    and print them per window batch."""
    ms = cs.cuda_ms(run, 10)
    if lib.swin_block_phases(None, 1):
        raise SystemExit("could not clear the phase counters")
    run()
    if lib.swin_block_phases(counters, 0):
        raise SystemExit("could not read the phase counters")
    plan = sb.kernel_plan(C, nH, dtype, round_qkv)
    regs, ctas_sm = sb.kernel_info(C, nH, dtype, round_qkv, lib)
    batches = -(-Wt // plan.WB)
    per = [c / batches for c in counters]
    if plan.body == 2:
        per = [c / first_warp_windows(plan, Wt, ctas_sm) for c in counters]
        total = sum(per[:9])
        print(f"  {tag:4s} {name:13s} C={C:3d} nH={nH:2d} Wt={Wt:5d} {ms:.4f} ms  narrow body, {plan.WB} window(s) a "
              f"warp, {plan.threads // 32} warps a CTA, {plan.smem_bytes} B shared, {regs} registers, {ctas_sm} CTAs "
              f"an SM, {total:.0f} cycles a window of one warp")
        print("    " + "  ".join(f"{n} {100 * c / total:.1f}%" for n, c in zip(NARROW, per)))
        return
    if plan.body == 1:
        # a consumer's cycles per batch, and the producers' per batch of the CTA
        total = sum(per[:10])
        weights = f"ring of {plan.ring}" if plan.ring else "weights resident"
        print(f"  {tag:4s} {name:13s} C={C:3d} nH={nH:2d} Wt={Wt:5d} {ms:.4f} ms  WB={plan.WB} G={plan.G} "
              f"HC={plan.HC} {plan.mp} rows, {plan.nwg} consumer warpgroups, {weights}, {plan.smem_bytes} B shared, "
              f"{regs} registers, {ctas_sm} CTAs an SM, {batches} window batches, {total:.0f} cycles a batch")
        print("    consumer: " + "  ".join(f"{n} {100 * c / total:.1f}%" for n, c in zip(HOPPER_CONSUMER, per)))
        print("    window producer, cycles a batch: " + "  ".join(
            f"{n} {c:.0f}" for n, c in zip(HOPPER_WINDOW, per[10:13])))
        if plan.ring:
            print("    weight producer, cycles a batch: " + "  ".join(
                f"{n} {c:.0f}" for n, c in zip(HOPPER_WEIGHT, per[13:15])))
        return
    total = sum(per[:10])
    print(f"  {tag:4s} {name:13s} C={C:3d} nH={nH:2d} Wt={Wt:5d} {ms:.4f} ms  "
          f"WB={plan.WB} G={plan.G} HC={plan.HC} {plan.smem_bytes} B shared, fma body, "
          f"{regs} registers, {ctas_sm} CTAs an SM, {batches} window batches, {total:.0f} cycles a batch")
    print("    " + "  ".join(f"{n} {100 * c / total:.1f}%" for n, c in zip(PHASES, per)))
    print("    in the products: " + "  ".join(f"{n} {100 * c / total:.1f}%" for n, c in zip(IN_PRODUCTS, per[10:15])))
    # FFMAs one warp executes in the loops of a CTA: 12 C^2 per row, over the
    # threads that hold a register tile; two such warps share a scheduler
    tiles = 5 * plan.WB * (plan.OT // plan.CN)
    ffma_per_thread = 25 * plan.WB * 12 * C * C / tiles
    print(f"    FFMA per cycle and warp inside the loops {ffma_per_thread / per[13]:.3f} "
          f"({plan.threads // 128} warps a scheduler)")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--serving", action="store_true", help="also the bf16 cst and wide shapes of a serving call")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("swin_block_phases: no CUDA device", file=sys.stderr)
        return 1
    lib = sb.bind(sb.build(defines=("SWIN_BLOCK_PHASES",)))
    lib.swin_block_phases.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.swin_block_phases.restype = ctypes.c_int
    sb._lib = lib  # the wrappers launch the instrumented build
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    gen = torch.Generator().manual_seed(cs.SEED)
    counters = (ctypes.c_ulonglong * 16)()
    print(f"cycles per window batch by phase, row-major, fp32, B={cs.TRAIN_B}, on {smi}")
    for name, C, nH, grid, _ in cs.ROW_LEVELS:
        xt, a, mask_nw = cs.level_args(C, nH, grid, cs.TRAIN_B, torch.float32, gen)
        a = cs.in_out_args(a)
        x = xt.reshape(-1, C)
        mask = None if mask_nw is None else mask_nw.t().reshape(-1, 1)
        measure(lib, counters, "row", name, lambda: sb.fused_swin_block(x, *a, num_heads=nH, pad_mask=mask),
                C, nH, xt.shape[0], torch.float32, False)
    if not args.serving:
        return 0
    print(f"cycles per window batch by phase, cst and wide, bf16, B={cs.B}, on {smi}")
    for name, C, nH, grid, _ in cs.LEVELS:
        xt, a, mask = cs.level_args(C, nH, grid, cs.B, torch.bfloat16, gen)
        x = xt.permute(2, 1, 0)  # the token-major view the models pass
        measure(lib, counters, "cst", name, lambda: sb.fused_swin_block_cst(x, *a, num_heads=nH, pad_mask=mask),
                C, nH, xt.shape[0], torch.bfloat16, True)
    for name, C, nH, grid in cs.WIDE_LEVELS:
        xt, a, _ = cs.level_args(C, nH, grid, cs.B, torch.bfloat16, gen)
        a = cs.in_out_args(a)
        x = xt.transpose(0, 1).contiguous()
        measure(lib, counters, "wide", name, lambda: sb.fused_swin_block_wide(x, *a, num_heads=nH),
                C, nH, xt.shape[0], torch.bfloat16, True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
