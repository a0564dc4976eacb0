#!/usr/bin/env python3
"""Build and drive the PyTorch port (swinwnet_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

1. builds the fused Swin-block kernels (ops/csrc/swin_block.cu) with nvcc and
   checks in its SASS (cuobjdump) that the tensor-core body has HMMA
   instructions and the fp32-FMA body none;
2. holds each kernel against its plain PyTorch version on the card, in bf16
   and fp32: `fused_swin_block_cst` at the five shapes the serving pipeline
   gives it and the five the RL step's half-size upscale gives it at B=4
   (every grid padded), token-major and channels-major; `fused_swin_block`
   (row-major) at every signature the gate sends to it with fused_deep in fp32 and with
   one window, one fewer and one more than a CTA takes,
   `fused_swin_block_wide` at its four on-path shapes, each also at a window
   count no CTA size divides; the bf16 tensor-core body of cst and wide at
   every on-path shape with all weights stored [out, in] and all [in, out],
   at one window fewer, as many and one more than its CTA takes, and with
   the output over the input; and the differentiable block's gradients
   against autograd through the plain fp32 reference, per layout;
3. serving: three [4, 2, 250, 480] requests through SwinWNetInference at the
   published width (embed 48, depths 2-2-2-2, heads 3-6-12-24, window 5) in
   bf16, random weights from a seed, live cross-attention; counts the
   kernel's launches (22 per call), checks the 8 stage tensors, compares
   with the pipeline run through the plain versions; then B=1 in fp32 (10);
4. training, this script's second main path: SwinWNetTrainingPipeline.run in
   fp32 with fused_blocks and fused_deep on [8, 2, 250, 480] batches, one
   epoch of 4 steps a stage (stage 3: even, odd, even, odd); before it, the
   first step of each stage against the same step with the blocks routed to
   their plain versions; checks losses, launches per step against the
   gate's counts, frozen and trained parameters;
5. the wide kernel's path: fused_layout="nmajor", one stage-1 step in fp32
   and one bf16 serving call, with launch counts and the plain comparison;
6. the d-space physics on the card: `Qwrapper(d_centers_hr).rebin` of
   [8, 1, 250, 480] against a float64 bincount of the same index map, and
   `diffraction_metrics_device` on 8 pairs of synthesized spectra against
   the host scipy oracle; identical and empty spectra give 0;
7. RL serving: three [4, 2, 250, 480] requests of synthesized Bragg
   patterns through RLInference in bf16, every stage and alpha against the
   plain route, 22 cst launches a call;
8. the REINFORCE fine-tune, on a model whose rollout has peaks (rl_model)
   and Bragg patterns with lines where they are, so that the reward is not
   0: the first RL step in fp32 against the same step on the plain route
   (reward and policy gradients not 0 on both; reward, losses, gradients),
   then RLTrainer for 4
   steps in bf16 at [4, 2, 250, 480] (scripts/rl_run.py's batch and dtype)
   with launches per step against the gate, every step's reward not 0, the frozen parameters
   unchanged bit for bit, and the reward and distance-gate times by CUDA
   events;
9. times: per call (with the serving call's device-busy share), per
   training and RL step, and per kernel and on-path shape the kernel, its
   plain version and its bound; for cst and wide the plan, the body it
   takes, its registers and CTAs an SM; for the row-major kernel also the
   same launch with [in, out]-stored weights and the plan of its CTAs; the
   rebin (segment sums, and index_add_ beside it) and the metrics alone.

Exits non-zero on any failure. The last lines are one JSON line on the
kernels, the card's name and power limit (nvidia-smi), and
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time

import numpy as np
import torch

from swinwnet_tpu_torch.models import AlphaPolicy, SwinWNet, apply_action
from swinwnet_tpu_torch.ops import swin_block as sb
from swinwnet_tpu_torch.ops.norms import denormalize_piecewise
from swinwnet_tpu_torch.ops.window import window_pad_mask_np
from swinwnet_tpu_torch.physics import Qwrapper, d_centers_hr, find_peaks_for_batch, peak_matching_loss
from swinwnet_tpu_torch.physics import peaks as peaks_mod
from swinwnet_tpu_torch.physics.device_metrics import diffraction_metrics_device
from swinwnet_tpu_torch.pipelines import STAGE_NAMES, RLInference, SwinWNetInference
from swinwnet_tpu_torch.train import (
    AdamW,
    FullModelTrainer,
    RLTrainer,
    SegmentatorTrainer,
    SwinWNetTrainingPipeline,
    UpscalerTrainer,
    masked_adamw,
    rl_step,
)
from swinwnet_tpu_torch.train import rl as rl_mod

SEED = 0
RL_SEED = 1  # the fine-tune's model (rl_model)
B = 4
H, W = 250, 480
N = 25
TRAIN_B = 8  # the C = 384 levels (24 windows an image) then pass the 128-window rule
# the H100 SXM's published peaks: HBM bytes/s, dense bf16 tensor-core and
# fp32 (CUDA-core, outside the tensor cores) operations/s; an fp32 bound is
# stated against the 67 TFLOP/s figure
HBM_BPS = 3.35e12
PEAK_OPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
# kernel against plain version: fp32 both ways, sums in other orders
# (observed ~3e-7 relative), so 1e-4 * max|ref| catches any indexing fault;
# bf16 rounds at the same points, but an fp32 sum that differs in its last
# bit can round to the neighbouring bf16 value (2^-8 relative per ulp), so
# 2e-2 * max|ref| is about five ulps of the largest output
BLOCK_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# the whole pipeline, kernel against plain, as (max, mean) absolute
# differences: seg maps are sigmoids in [0, 1]; images_masked_hr is taken
# relative to its max. In bf16, images_masked_hr is the bf16 SR output put
# through expm1 and scaled by each image's range, so one bf16 step of the SR
# output (2^-8 relative) becomes up to ~2^-7 of the range: 5e-2 is about six
# such steps at the worst pixel, and the mean must stay near one tenth of one
PIPE_TOL = {torch.float32: (1e-3, 1e-4), torch.bfloat16: (5e-2, 1e-3)}
# RL serving compares every stage at PIPE_TOL, but for one: upscaled_norm is
# the bf16 SR output itself (times the gain sigmoid(alpha)), unscaled by
# expm1 or a range. The routes' rounding differences, begun in the first
# block and carried through the upscaler's bf16 layers, leave its mean
# error at about 1.2e-3 of its max on the card, so the mean is held to half
# a bf16 step at its max (2^-9), its max to PIPE_TOL's. A control in
# rl_serve (every cst launch without its pad mask) must fail the comparison
RL_UPSCALED_MEAN_TOL = 2.0 ** -9
# (name, C, nH, token grid at B=1, launches per pipeline call in bf16)
LEVELS = [
    ("encoder L0", 48, 3, (125, 240), 6),
    ("encoder L1", 96, 6, (63, 120), 6),
    ("decoder last", 96, 3, (125, 240), 6),
    ("SR level 1", 24, 3, (250, 480), 2),
    ("SR level 2", 12, 3, (500, 960), 2),
]
LAUNCHES_PER_CALL = {torch.bfloat16: 22, torch.float32: 10}
# the row-major kernel's signatures with fused_deep in fp32 (every level above
# the fp32 cap of 48): (name, C, nH, token grid, batch for the check). B=1
# where that gives at least 128 windows, else the training batch.
ROW_LEVELS = [
    ("encoder L1", 96, 6, (63, 120), 1),
    ("encoder L2", 192, 12, (32, 60), TRAIN_B),
    ("encoder L3", 384, 24, (16, 30), TRAIN_B),  # the bottleneck has this signature too
    ("decoder 0", 384, 12, (32, 60), TRAIN_B),
    ("decoder 1", 192, 6, (63, 120), 1),
    ("decoder last", 96, 3, (125, 240), 1),
]
# the wide kernel's shapes under fused_layout="nmajor": fp32 training reaches
# the first three (C <= 48), bf16 serving all four; tiling grids only
WIDE_LEVELS = [
    ("encoder L0", 48, 3, (125, 240)),
    ("SR level 1", 24, 3, (250, 480)),
    ("SR level 2", 12, 3, (500, 960)),
    ("decoder last", 96, 3, (125, 240)),
]
# the RL fine-tune as scripts/rl_run.py runs it: batch 4 (:46), bf16 compute
# (:52), the 1241-bin d_centers_hr grid
RL_B = 4
# the half-size upscale of an RL step at RL_B, run twice a step (the reward's
# rollout and the update's forward): every grid pads. With segment_1's six
# launches at LEVELS' full-size shapes they are the 26 cst launches of a bf16
# RL step; in fp32 the C <= 48 ones run (with segment_1's two, 14)
RL_LEVELS = [
    ("RL encoder L0", 48, 3, (63, 120), 4),
    ("RL encoder L1", 96, 6, (32, 60), 4),
    ("RL decoder last", 96, 3, (63, 120), 4),
    ("RL SR level 1", 24, 3, (126, 240), 4),
    ("RL SR level 2", 12, 3, (252, 480), 4),
]
ODD_WINDOWS = 1201  # a prime: no count of windows per CTA divides it
# first training step, kernel route against plain route (fp32): the two
# forwards differ by summation order (~3e-7 relative per block) and the two
# backwards are the same fp32 reference on inputs that differ that little,
# so the loss agrees to 1e-5 relative and each parameter's gradient to
# 1e-3 of its largest element; a one-element leaf (a cross-attention gamma)
# is a sum of products of either sign that nearly cancel, and gets 2e-2
TRAIN_LOSS_RTOL, TRAIN_GRAD_TOL, TRAIN_SCALAR_GRAD_TOL = 1e-5, 1e-3, 2e-2
# rebin against a float64 bincount: fp32 sums of up to ~400 pixels a bin
# (observed 4e-7 of the largest bin on the card), so 1e-5 of each bin catches
# any indexing fault; the device metrics against the host scipy oracle with
# the tolerance of tests/test_physics_device.py
REBIN_RTOL, METRIC_TOL = 1e-5, 2e-3


def n_windows(grid, batch):
    return batch * (-(-grid[0] // 5)) * (-(-grid[1] // 5))


def level_args(C, nH, grid, batch, dtype, gen):
    """Random block operands at a level's shape, on the card: x as the
    token-major [Wt, N, C] windows BasicLayer makes, the pad mask when the
    grid does not tile."""
    A = lambda *s: torch.randn(*s, generator=gen) * 0.05
    args = [
        torch.rand(C, generator=gen) + 0.5, A(C), A(3 * C, C).to(dtype), A(3 * C),
        A(nH, N, N), A(C, C).to(dtype), A(C), torch.rand(C, generator=gen) + 0.5, A(C),
        A(4 * C, C).to(dtype), A(4 * C), A(C, 4 * C).to(dtype), A(C),
    ]
    args = [a.cuda() for a in args]
    Wt = n_windows(grid, batch)
    m = window_pad_mask_np(grid[0], grid[1], 5)
    mask = None
    if m is not None:
        mask = torch.from_numpy(np.tile(m[:, :, 0], (batch, 1))).cuda().t()
    xt = torch.randn(Wt, N, C, generator=gen).to(dtype).cuda()
    return xt, args, mask


def cuda_ms(fn, reps):
    fn()
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def block_cost(C, nH, Wt, dtype, masked):
    """Operations and bytes one block over Wt windows needs: x read and the
    output written once, weights and fp32 parameters read once."""
    item = torch.tensor([], dtype=dtype).element_size()
    flops = Wt * N * (2 * C * 3 * C + 2 * 2 * N * C + 2 * C * C + 2 * 2 * C * 4 * C)
    nbytes = 2 * Wt * N * C * item + 12 * C * C * item
    nbytes += 4 * (C * 13 + nH * N * N) + (4 * N * Wt if masked else 0)
    return flops, nbytes


@contextlib.contextmanager
def plain_blocks():
    """Route the differentiable block's three entries to their plain
    versions on the card, for comparison."""
    orig = (sb.fused_swin_block_cst, sb.fused_swin_block, sb.fused_swin_block_wide)
    sb.fused_swin_block_cst = sb.swin_block_plain
    sb.fused_swin_block = sb.swin_block_rowmajor_plain
    sb.fused_swin_block_wide = sb.swin_block_wide_plain
    try:
        yield
    finally:
        sb.fused_swin_block_cst, sb.fused_swin_block, sb.fused_swin_block_wide = orig


def launches():
    return [k.launches for k in sb.KERNELS]


def gate_route(C, grid, batch, dtype, fused_deep, layout):
    """The gate, written out: which kernel a level of width C on `grid`
    tokens goes to (index into sb.KERNELS), or None."""
    if n_windows(grid, batch) < 128:
        return None
    if C <= (96 if dtype == torch.bfloat16 else 48):
        if layout == "nmajor":
            return 2 if grid[0] % 5 == 0 and grid[1] % 5 == 0 else None
        return 0
    return 1 if fused_deep and C <= 384 else None


def half(grid):
    return (-(-grid[0] // 2), -(-grid[1] // 2))


def tower_launches(image_hw, batch, dtype, fused_deep, layout, with_sr_head):
    """Launches per kernel of one tower pass (encoder, bottleneck, decoder,
    and the SR head when the tower is the upscaler) over a [h, w] image at
    patch size 2 (or a [2h, 2w] one at scale 2): two blocks a level."""
    g0 = half(image_hw)
    g1 = half(g0)
    g2 = half(g1)
    g3 = half(g2)
    levels = [(48, g0), (96, g1), (192, g2), (384, g3), (384, g3), (384, g2), (192, g1), (96, g0)]
    if with_sr_head:
        levels += [(24, (2 * g0[0], 2 * g0[1])), (12, (4 * g0[0], 4 * g0[1]))]
    out = [0, 0, 0]
    for C, grid in levels:
        k = gate_route(C, grid, batch, dtype, fused_deep, layout)
        if k is not None:
            out[k] += 2
    return out


def add(*counts):
    return [sum(c) for c in zip(*counts)]


def expected_launches(what, batch, dtype, fused_deep, layout):
    """Launches per kernel of one serving call or one training or RL step,
    from the gate: segment_1 and segment_2 are tower passes on the 250x480
    token source, upscale is a tower pass with the SR head; stage 2, the
    even step of stage 3 and the RL step upscale the half-size image."""
    tower = lambda hw, head: tower_launches(hw, batch, dtype, fused_deep, layout, head)
    seg, up_full, up_half = tower((H, W), False), tower((H, W), True), tower((H // 2, W // 2), True)
    return {
        "serve": add(seg, up_full, seg),
        "stage1": seg,
        "stage2": add(seg, up_half),
        "stage3_even": add(seg, up_half),
        "stage3_odd": add(seg, up_full, seg),
        # segment_1, the reward's no-grad rollout and the update's forward
        # (the backward recomputes in plain torch and launches nothing)
        "rl": add(seg, up_half, up_half),
    }[what]


def report(tag, out, ref, dtype, extra_ok=True):
    err = (out.float() - ref.float()).abs().max().item()
    tol = BLOCK_TOL[dtype] * ref.float().abs().max().item()
    ok = err <= tol and extra_ok
    print(f"  {tag} {str(dtype)[6:]:8s} max_abs_err={err:.3e} tol={tol:.3e} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"kernel disagrees with its plain version at {tag} ({dtype})")
    return err


def check_kernel(dtype, gen):
    """`fused_swin_block_cst` against plain at the five serving shapes (B=1),
    the five shapes of the RL step's half-size upscale (B=RL_B, padded) and
    a window count no CTA size divides; returns the largest absolute
    error."""
    worst = 0.0
    shapes = [(name, C, nH, grid, 1) for name, C, nH, grid, _ in LEVELS]
    shapes += [(name, C, nH, grid, RL_B) for name, C, nH, grid, _ in RL_LEVELS]
    for name, C, nH, grid, batch in shapes + [("odd count", 48, 3, (5, 5 * ODD_WINDOWS), 1)]:
        xt, args, mask = level_args(C, nH, grid, batch, dtype, gen)
        for layout, x in (("token-major", xt.permute(2, 1, 0)), ("channels-major", xt.permute(2, 1, 0).contiguous())):
            out = sb.fused_swin_block_cst(x, *args, num_heads=nH, pad_mask=mask)
            torch.cuda.synchronize()
            ref = sb.swin_block_plain(x, *args, num_heads=nH, pad_mask=mask)
            tag = f"cst  {name:15s} C={C:3d} nH={nH:2d} Wt={x.shape[2]:6d} mask={mask is not None!s:5s} {layout:14s}"
            worst = max(worst, report(tag, out, ref, dtype, out.stride() == x.stride()))
    return worst


def in_out_args(args):
    """level_args' operands for the row-major and wide entry points: every
    matrix [in, out], as the transposed view of the [out, in] storage an
    nn.Linear holds (what BasicLayer passes); wproj is [in, out] already."""
    args = list(args)
    for i in (2, 9, 11):
        args[i] = args[i].t()
    args[5] = args[5].t().contiguous().t()
    return args


def check_tensor_cores(gen):
    """The bf16 tensor-core body (cst and wide, C <= 96) at every on-path
    shape with all four weights stored [out, in] and all [in, out]; at one
    window fewer, as many and one more than its CTA takes (cst with a random
    pad mask); and with the output written over the input (the launcher
    called on one tensor), which the kernel allows. Returns the largest
    absolute error per entry."""
    bf16 = torch.bfloat16
    worst = {"cst": 0.0, "wide": 0.0}
    shapes = [("cst", *lv[:4]) for lv in LEVELS] + [("wide", *lv) for lv in WIDE_LEVELS]
    for entry, name, C, nH, grid in shapes:
        plan = sb.kernel_plan(C, nH, bf16)
        if plan.body == 0:
            raise SystemExit(f"{entry} at C={C} nH={nH} does not take the tensor-core body: {plan}")
        xt, args, mask = level_args(C, nH, grid, 1, bf16, gen)
        ragged = sorted({plan.WB - 1, plan.WB, plan.WB + 1} - {0})
        cases = [(grid, mask, "[out, in]"), (grid, mask, "[in, out]")]
        cases += [((5, 5 * Wt), None, ("[out, in]", "[in, out]")[i % 2]) for i, Wt in enumerate(ragged)]
        for g, m, order in cases:
            if g != grid:
                xt = torch.randn(n_windows(g, 1), N, C, generator=gen).to(bf16).cuda()
                m = (torch.rand(N, xt.shape[0], generator=gen) > 0.3).float().cuda() if entry == "cst" else None
            if entry == "cst":
                a = list(args)
                if order == "[in, out]":  # wqkv_t, w1_t, w2_t as views of [in, out] storage; wproj_t is
                    for j in (2, 9, 11):
                        a[j] = a[j].t().contiguous().t()
                else:  # wproj_t as a view of [out, in] storage; the rest are
                    a[5] = a[5].t().contiguous().t()
                x = xt.permute(2, 1, 0)
                out = sb.fused_swin_block_cst(x, *a, num_heads=nH, pad_mask=m)
                ref = sb.swin_block_plain(x, *a, num_heads=nH, pad_mask=m)
            else:
                a = in_out_args(args)  # [in, out] views of [out, in] storage
                if order == "[in, out]":
                    a = [t.contiguous() if j in (2, 5, 9, 11) else t for j, t in enumerate(a)]
                x = xt.transpose(0, 1).contiguous()
                out = sb.fused_swin_block_wide(x, *a, num_heads=nH)
                ref = sb.swin_block_wide_plain(x, *a, num_heads=nH)
            torch.cuda.synchronize()
            tag = (f"{entry:4s} {name:13s} C={C:3d} nH={nH:2d} Wt={xt.shape[0]:6d} mask={str(m is not None):5s} "
                   f"weights {order} tensor cores")
            worst[entry] = max(worst[entry], report(tag, out, ref, bf16))
        # the output over the input: the launcher on one tensor
        if entry == "cst":
            x = xt.permute(2, 1, 0).clone()
            ref = sb.swin_block_plain(x, *args, num_heads=nH, pad_mask=m)
            w_oi = (args[2], args[5].t(), args[9], args[11])
            fp = (args[0], args[1], args[3], args[6], args[7], args[8], args[10], args[12], args[4])
            sb._launch(sb.fused_swin_block_cst, x, x, m, w_oi, fp, nH, True, True)
        else:
            a = in_out_args(args)
            x = xt.transpose(0, 1).contiguous()
            ref = sb.swin_block_wide_plain(x, *a, num_heads=nH)
            w_oi = (a[2].t(), a[5].t(), a[9].t(), a[11].t())
            fp = (a[0], a[1], a[3], a[6], a[7], a[8], a[10], a[12], a[4])
            sb._launch(sb.fused_swin_block_wide, x.permute(2, 0, 1), x.permute(2, 0, 1), None, w_oi, fp, nH, True, False)
        torch.cuda.synchronize()
        tag = f"{entry:4s} {name:13s} C={C:3d} nH={nH:2d} Wt={xt.shape[0]:6d} output over the input, tensor cores"
        worst[entry] = max(worst[entry], report(tag, x, ref, bf16))
    return worst


def sass_hmma(lib):
    """HMMA instructions per kernel instance in the built library's SASS
    (cuobjdump), as {mangled name: count}."""
    from torch.utils.cpp_extension import CUDA_HOME

    res = subprocess.run([f"{CUDA_HOME}/bin/cuobjdump", "-sass", str(lib)], capture_output=True, text=True, check=True)
    counts = {}
    for part in res.stdout.split("Function : ")[1:]:
        name = part.split(None, 1)[0]
        counts[name] = counts.get(name, 0) + part.count("HMMA")
    return counts


def check_sass(lib):
    """The tensor-core body's SASS has HMMA instructions; the fp32-FMA
    body's instances have none."""
    counts = sass_hmma(lib)
    mma = {k: v for k, v in counts.items() if "swin_block_mma_kernel" in k}
    fma = {k: v for k, v in counts.items() if "swin_block_kernel" in k}
    print(f"  SASS: tensor-core body HMMA {list(mma.values())}; fp32-FMA body instances HMMA "
          f"{sorted(fma.values())} ({len(fma)} instances)")
    if not mma or min(mma.values()) == 0 or max(fma.values(), default=0) > 0:
        raise SystemExit("the tensor-core body has no HMMA, or the fp32-FMA body has some")


def check_rowmajor(dtype, gen):
    """`fused_swin_block` against `swin_block_rowmajor_plain` at the
    fused_deep signatures, with the [Wt*N, 1] pad mask where the grid pads,
    at a prime window count, and at C = 96 and 192 with one window and one
    fewer and one more than a CTA takes."""
    levels = ROW_LEVELS + [("odd count", 96, 6, (5, 5 * ODD_WINDOWS), 1)]
    for C, nH in ((96, 3), (192, 12)):
        WB = sb.kernel_plan(C, nH, dtype, round_qkv=False).WB
        levels += [(f"{Wt} window{'s' * (Wt > 1)}", C, nH, (5, 5 * Wt), 1) for Wt in sorted({1, WB - 1, WB + 1} - {0})]
    worst = 0.0
    for name, C, nH, grid, batch in levels:
        xt, args, mask_nw = level_args(C, nH, grid, batch, dtype, gen)
        args = in_out_args(args)
        x = xt.reshape(-1, C)
        mask = None if mask_nw is None else mask_nw.t().reshape(-1, 1)
        out = sb.fused_swin_block(x, *args, num_heads=nH, pad_mask=mask)
        torch.cuda.synchronize()
        ref = sb.swin_block_rowmajor_plain(x, *args, num_heads=nH, pad_mask=mask)
        tag = f"row  {name:13s} C={C:3d} nH={nH:2d} Wt={xt.shape[0]:6d} mask={mask is not None!s:5s}"
        worst = max(worst, report(tag, out, ref, dtype))
    return worst


def check_wide(dtype, gen):
    """`fused_swin_block_wide` against `swin_block_wide_plain` at its on-path
    shapes (B=1); C = 96 is on the path in bf16 only."""
    worst = 0.0
    for name, C, nH, grid in WIDE_LEVELS + [("odd count", 48, 3, (5, 5 * ODD_WINDOWS))]:
        if C == 96 and dtype != torch.bfloat16:
            continue
        xt, args, _ = level_args(C, nH, grid, 1, dtype, gen)
        x = xt.transpose(0, 1).contiguous()  # [N, Wt, C]
        out = sb.fused_swin_block_wide(x, *in_out_args(args), num_heads=nH)
        torch.cuda.synchronize()
        ref = sb.swin_block_wide_plain(x, *in_out_args(args), num_heads=nH)
        tag = f"wide {name:13s} C={C:3d} nH={nH:2d} Wt={xt.shape[0]:6d} mask=False"
        worst = max(worst, report(tag, out, ref, dtype))
    return worst


def check_gradients(gen):
    """Per layout, at the encoder L1 shape (padded grid; the wide kernel at
    encoder L0): the Function's forward against the fp32 reference
    (BLOCK_TOL) and its gradients against autograd through that reference.
    The backward is that same function, so they agree to fp32 rounding:
    1e-6 * max|g| per tensor."""
    for layout in sb.LAYOUTS:
        C, nH, grid = (48, 3, (125, 240)) if layout == "nmajor" else (96, 6, (63, 120))
        xt, args, mask_nw = level_args(C, nH, grid, 1, torch.float32, gen)
        if layout == "cmajor":
            x, mask = xt.permute(2, 1, 0), mask_nw
        elif layout == "rowmajor":
            x, mask, args = xt.reshape(-1, C), mask_nw.t().reshape(-1, 1), in_out_args(args)
        else:
            x, mask, args = xt.transpose(0, 1).contiguous(), None, in_out_args(args)
        ct = torch.randn(x.shape, generator=gen).cuda()
        a = [t.detach().clone().requires_grad_(True) for t in [x] + args]
        b = [t.detach().clone().requires_grad_(True) for t in [x] + args]
        before = sum(launches())
        out = sb.fused_block_autodiff(layout, nH, a[0], mask, *a[1:])
        ref = sb._layout_reference(layout, nH, b[0], mask, *b[1:])
        got = torch.autograd.grad(out, a, ct)
        want = torch.autograd.grad(ref, b, ct)
        torch.cuda.synchronize()
        fwd = ((out - ref).abs().max() / ref.abs().max()).item()
        grad = max(((p - q).abs().max() / q.abs().max()).item() for p, q in zip(got, want))
        ok = sum(launches()) == before + 1 and fwd <= BLOCK_TOL[torch.float32] and grad <= 1e-6
        print(f"  grad {layout:8s} C={C:3d} Wt={xt.shape[0]:5d} forward vs fp32 reference {fwd:.3e} (tol 1e-4), "
              f"gradients vs autograd of the reference {grad:.3e} (tol 1e-6) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"the differentiable block disagrees with its reference ({layout})")


def build_model(dtype, seed=SEED, **kw):
    gen = torch.Generator().manual_seed(seed)
    model = SwinWNet(in_chans=1, error_matrix=True, embed_dim=48, depths=(2, 2, 2, 2),
                     num_heads=(3, 6, 12, 24), window_size=5, patch_size=2,
                     fused_blocks=True, dtype=dtype, device="cuda", generator=gen, **kw)
    with torch.no_grad():  # gamma starts at 0: make the cross-attention live
        for ca in (model.ca_seg_to_sr, model.ca_sr_to_seg):
            for blk in ca.blocks:
                blk.gamma.fill_(0.5)
    return model


def serve(dtype, batch, n_calls, rng, profile=False, **model_kw):
    """Drive the pipeline; returns (first request's stages, per-call ms,
    launches per kernel per call, plain stages, plain ms)."""
    model = build_model(dtype, **model_kw)
    infer = SwinWNetInference(model)
    requests = [rng.uniform(0, 1e3, (batch, 2, H, W)).astype(np.float32) for _ in range(n_calls)]
    infer(requests[0])  # warm-up: cuDNN and allocator
    torch.cuda.synchronize()

    sb.reset_counts()
    per_call, call_ms, first = [], [], None
    for req in requests:
        before = launches()
        t0 = time.perf_counter()
        infer(req)
        torch.cuda.synchronize()
        call_ms.append((time.perf_counter() - t0) * 1e3)
        per_call.append([b - a for a, b in zip(before, launches())])
        if first is None:
            first = {k: getattr(infer, k).clone() for k in STAGE_NAMES}
    total = launches()

    with plain_blocks():
        infer(requests[0])
        torch.cuda.synchronize()
        plain = {k: getattr(infer, k).clone() for k in STAGE_NAMES}
        t0 = time.perf_counter()
        infer(requests[0])
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
    if launches() != total:
        raise SystemExit("the plain pipeline launched a kernel")
    if profile:
        profile_call(lambda: infer(requests[0]), "one serving call")
    del model, infer
    return first, call_ms, per_call, total, plain, plain_ms


PROFILES = {}  # what -> (wall ms, device-busy ms) of profile_call


def profile_call(fn, what):
    """Device time by kernel over one call of `fn` (torch.profiler), and the
    share of its wall time the device was busy (kept in PROFILES)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], acc_events=True) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # kernel events only: the aten ops above them report the same device time
    rows = [(e.key, e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    PROFILES[what] = (wall_ms, busy)
    fused = [r for r in rows if "swin_block_kernel" in r[0] or "swin_block_mma_kernel" in r[0]]
    print(f"  profile of {what}: wall {wall_ms:.1f} ms, device busy {busy:.1f} ms "
          f"({100 * busy / wall_ms:.1f}%), {len(rows)} kernel kinds; the Swin-block kernels "
          f"{sum(r[1] for r in fused):.1f} ms in {sum(r[2] for r in fused)} launches, "
          f"{100 * sum(r[1] for r in fused) / max(busy, 1e-9):.1f}% of the device time")
    for key, ms, count in rows[:12]:
        print(f"    {ms:8.3f} ms {100 * ms / max(busy, 1e-9):5.1f}%  x{count:<4d} {key[:90]}")


def check_pipeline(dtype, batch, stages, plain, per_call, want):
    if any(n != want for n in per_call):
        raise SystemExit(f"{dtype}: kernel launches per call {per_call}, expected {want}")
    shapes = {
        "images": (batch, 2, H, W), "seg_map_lr": (batch, 1, H, W),
        "images_masked_lr": (batch, 2, H, W), "norm": (batch, 2, H, W),
        "upscaled_norm": (batch, 2, 2 * H, 2 * W), "upscaled_denorm": (batch, 2, 2 * H, 2 * W),
        "seg_map_hr": (batch, 1, 2 * H, 2 * W), "images_masked_hr": (batch, 2, 2 * H, 2 * W),
    }
    for k, shape in shapes.items():
        t = stages[k]
        if tuple(t.shape) != shape or not torch.isfinite(t).all():
            raise SystemExit(f"{dtype}: stage {k} has shape {tuple(t.shape)} (want {shape}) or non-finite values")
    tol_max, tol_mean = PIPE_TOL[dtype]
    for k in ("seg_map_lr", "seg_map_hr", "images_masked_hr"):
        a, b = stages[k].float(), plain[k].float()
        err, mean = (a - b).abs().max().item(), (a - b).abs().mean().item()
        scale = 1.0 if k.startswith("seg") else b.abs().max().item()
        ok = err <= tol_max * scale and mean <= tol_mean * scale
        print(f"  {k:17s} kernel vs plain: max_abs={err:.3e} (tol {tol_max * scale:.3e}) "
              f"mean_abs={mean:.3e} (tol {tol_mean * scale:.3e}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"{dtype} pipeline: {k} disagrees with the plain pipeline")


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------


def training_batches(n, batch, rng):
    """(images uniform(0, 1e3) [B, 2, 250, 480], binary masks [B, 250, 480])."""
    return [(rng.uniform(0, 1e3, (batch, 2, H, W)).astype(np.float32),
             (rng.uniform(size=(batch, H, W)) > 0.85).astype(np.float32)) for _ in range(n)]


class ProbeLoader:
    """A loader (an iterable of numpy batches with len()) that notes, each
    time the trainer comes back for a batch, the host time after a
    synchronize and the kernels' launch counts: the differences between two
    notes are one optimizer step. Each epoch's start keeps a copy of the
    model's parameters."""

    def __init__(self, batches, model):
        self.batches, self.model = batches, model
        self.epochs = []  # one {"params": ..., "marks": [(t, launches), ...]} per epoch

    def __len__(self):
        return len(self.batches)

    def mark(self):
        torch.cuda.synchronize()
        self.epochs[-1]["marks"].append((time.perf_counter(), launches()))

    def __iter__(self):
        self.epochs.append({"params": snapshot(self.model), "marks": []})
        for batch in self.batches:
            self.mark()
            yield batch
        self.mark()

    def steps(self, epoch):
        """[(ms, launches per kernel)] per step of `epoch`."""
        marks = self.epochs[epoch]["marks"]
        return [((t1 - t0) * 1e3, [b - a for a, b in zip(l0, l1)])
                for (t0, l0), (t1, l1) in zip(marks, marks[1:])]


def snapshot(model):
    return {k: p.detach().clone() for k, p in model.named_parameters()}


STAGE_TRAINS = {
    "stage1": lambda top: top == "patch_embed" or top.startswith("segmentator_"),
    "stage2": lambda top: top.startswith("upscaler_"),
    "stage3": lambda top: True,
    "rl": lambda top: top.startswith("upscaler_") or top == "ca_seg_to_sr",
}


def check_frozen(stage, before, after):
    """Frozen parameters unchanged bit for bit, trainable ones changed."""
    trains = STAGE_TRAINS[stage]
    n_frozen = n_moved = 0
    for k in before:
        same = torch.equal(before[k], after[k])
        if trains(k.split(".")[0]):
            n_moved += 1
            if same:
                raise SystemExit(f"{stage}: trainable parameter {k} did not change")
        else:
            n_frozen += 1
            if not same:
                raise SystemExit(f"{stage}: frozen parameter {k} changed")
    print(f"  {stage}: {n_moved} trainable parameters changed, {n_frozen} frozen ones unchanged bit for bit")


def first_step(kind, batch, plain, **model_kw):
    """One training step from the seed's weights; returns (loss, gradients
    by name, launches). `kind` is stage1, stage2, stage3_even or stage3_odd."""
    model = build_model(torch.float32, **model_kw).train()
    cls = {"stage1": SegmentatorTrainer, "stage2": UpscalerTrainer}.get(kind, FullModelTrainer)
    trainer = cls(model, [batch], num_epochs=1, warmup_epochs=1, verbose=False)
    before = launches()
    with plain_blocks() if plain else contextlib.nullcontext():
        if cls is FullModelTrainer:
            loss = trainer.train_step(*batch, even=kind == "stage3_even")["loss"]
        else:
            loss = trainer.train_step(*batch)
    torch.cuda.synchronize()
    grads = {k: p.grad.clone() for k, p in model.named_parameters() if p.grad is not None}
    return float(loss), grads, [b - a for a, b in zip(before, launches())]


def compare_first_steps(kind, batch, **model_kw):
    """The first step through the kernels against the same step through the
    plain versions, both on the card."""
    loss_k, grads_k, n_k = first_step(kind, batch, plain=False, **model_kw)
    loss_p, grads_p, n_p = first_step(kind, batch, plain=True, **model_kw)
    want = expected_launches(kind, len(batch[0]), torch.float32, model_kw.get("fused_deep", False),
                             model_kw.get("fused_layout", "cmajor"))
    worst, worst_name = 0.0, ""
    for k, g in grads_p.items():
        scale = g.abs().max().item()
        if scale == 0:
            continue
        rel = (grads_k[k] - g).abs().max().item() / scale
        tol = TRAIN_SCALAR_GRAD_TOL if g.numel() == 1 else TRAIN_GRAD_TOL
        if rel / tol > worst:
            worst, worst_name = rel / tol, f"{k} ({rel:.2e} of its max, tol {tol:.0e})"
    rel_loss = abs(loss_k - loss_p) / abs(loss_p)
    ok = (np.isfinite(loss_k) and rel_loss <= TRAIN_LOSS_RTOL and worst <= 1.0 and n_k == want
          and n_p == [0, 0, 0] and grads_k.keys() == grads_p.keys())
    print(f"  {kind:11s} first step: loss {loss_k:.6f} vs plain route {loss_p:.6f} (rel {rel_loss:.1e}, tol "
          f"{TRAIN_LOSS_RTOL:.0e}); {len(grads_k)} gradients, worst {worst_name}; launches {n_k} "
          f"(gate: {want}), plain route {n_p} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"{kind}: the first training step disagrees with the plain route")


def train_main_path(rng):
    """SwinWNetTrainingPipeline.run, one epoch of four batches a stage
    (stage 3: even, odd, even, odd). Returns (per-kind step times,
    launches in the run)."""
    model = build_model(torch.float32, fused_deep=True).train()
    loader = ProbeLoader(training_batches(4, TRAIN_B, rng), model)
    torch.cuda.reset_peak_memory_stats()
    sb.reset_counts()
    pipe = SwinWNetTrainingPipeline(model, loader, seg_epochs=1, sr_epochs=1, full_epochs=1,
                                    warmup_epochs=1, verbose=True)
    _, hist = pipe.run()
    torch.cuda.synchronize()
    total = launches()
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30

    losses = [hist["stage1"]["train_loss"][0], hist["stage2"]["train_loss"][0],
              *(hist["stage3"]["train"][0][k] for k in ("loss", "seg_lr", "seg_hr", "rec"))]
    if not all(np.isfinite(v) for v in losses):
        raise SystemExit(f"training: a loss is not finite: {losses}")
    after = [e["params"] for e in loader.epochs[1:]] + [snapshot(model)]
    records = {}
    for i, stage in enumerate(("stage1", "stage2", "stage3")):
        check_frozen(stage, loader.epochs[i]["params"], after[i])
        steps = loader.steps(i)
        for j, (ms, n) in enumerate(steps):
            kind = stage if stage != "stage3" else ("stage3_even" if j % 2 == 0 else "stage3_odd")
            want = expected_launches(kind, TRAIN_B, torch.float32, True, "cmajor")
            if n != want:
                raise SystemExit(f"{kind} step {j}: launches {n}, the gate implies {want}")
            records.setdefault(kind, []).append(ms)
        print(f"  {stage}: {len(steps)} steps, launches per step [cst, row-major, wide] "
              f"{[n for _, n in steps]}, ms per step {[round(ms, 1) for ms, _ in steps]}")
    if [len(loader.steps(i)) for i in range(3)] != [4, 4, 4]:
        raise SystemExit("training: expected 4 steps a stage")
    print(f"  peak device memory in training {peak_gb:.2f} GiB; launches in the run {total}")

    batch = loader.batches[1]
    trainer = FullModelTrainer(model, [batch], num_epochs=1, warmup_epochs=1, verbose=False)
    profile_call(lambda: trainer.train_step(*batch, even=False), f"one stage-3 odd step, B={TRAIN_B}, fp32")
    del model, trainer
    return records, total


# ---------------------------------------------------------------------------
# The d-space physics and the REINFORCE fine-tune
# ---------------------------------------------------------------------------


def synth_spectra(rng, batch, n, n_peaks=8):
    """[batch, n] sums of Gaussian peaks over d in [0, 7.5] (the spectra of
    tests/test_physics_device.py)."""
    x = np.linspace(0, 7.5, n)
    out = np.zeros((batch, n))
    for b in range(batch):
        for _ in range(n_peaks):
            c, w, a = rng.uniform(0.3, 7.0), rng.uniform(0.03, 0.12), rng.uniform(0.3, 5.0)
            out[b] += a * np.exp(-0.5 * ((x - c) / w) ** 2)
    return out.astype(np.float32)


def bragg_patterns(rng, batch, lines=()):
    """[batch, 2, 250, 480] synthesized diffraction patterns on the
    detector's grid (lambda in [0.1, 10] A down the rows, theta in
    [-170, 170] degrees across): 6-10 random d-spacings and the d-spacings
    `lines`, each a Gaussian line at lambda = 2 d sin(|theta|/2) of width
    0.04 A + 2% of lambda, over a flat background, in counts, and their
    Poisson error sqrt(I)."""
    lam = np.linspace(0.1, 10.0, H)[:, None]
    s = 2.0 * np.sin(np.abs(np.deg2rad(np.linspace(-170.0, 170.0, W)))[None, :] / 2.0)
    out = []
    for _ in range(batch):
        img = np.full((H, W), 2.0)
        ds = np.concatenate([rng.uniform(0.6, 6.0, rng.integers(6, 11)), lines])
        for d, a in zip(ds, rng.uniform(300.0, 1000.0, len(ds))):
            lam_b = d * s
            img += a * np.exp(-0.5 * ((lam - lam_b) / (0.04 + 0.02 * lam_b)) ** 2)
        out.append(img)
    counts = np.stack(out)[:, None]
    return np.concatenate([counts, np.sqrt(counts)], axis=1).astype(np.float32)


class EventTimer:
    """Device time of the calls of wrapped functions, by CUDA events
    recorded around each call (a host sync inside a call is in its span)."""

    def __init__(self):
        self.spans = {}

    def wrap(self, name, fn):
        def timed(*args, **kwargs):
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            out = fn(*args, **kwargs)
            e1.record()
            self.spans.setdefault(name, []).append((e0, e1))
            return out
        return timed

    def ms(self, name):
        torch.cuda.synchronize()
        return [e0.elapsed_time(e1) for e0, e1 in self.spans.get(name, [])]


def check_physics(rng):
    """The rebin against a float64 bincount of its own index map, and the
    device metrics against the host scipy oracle on the card; returns the
    times of the rebin (segment sums and, beside it, index_add_) and of the
    metrics at the RL reward's shapes."""
    qw = Qwrapper(fixed_centers=d_centers_hr)
    n = qw.n_bins
    x = rng.uniform(0, 1e3, (8, 1, H, W)).astype(np.float32)
    x_dev = torch.from_numpy(x).cuda()
    got = qw.rebin(x_dev)
    idx = qw._indices_for(H, W)
    want = np.stack([np.bincount(idx, weights=img.ravel().astype(np.float64), minlength=n + 1)[:n] for img in x[:, 0]])
    err = float(np.abs(got.cpu().numpy() - want).max() / np.abs(want).max())
    ok = got.device == x_dev.device and np.allclose(got.cpu().numpy(), want, rtol=REBIN_RTOL, atol=0)
    ok = ok and torch.equal(got, qw.rebin(x_dev))
    print(f"  rebin [8, 1, {H}, {W}] -> [8, {n}] on the card against a float64 bincount: max err {err:.2e} of the "
          f"largest bin (rtol {REBIN_RTOL:.0e} a bin), the same bits when repeated {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("physics: the rebin disagrees with the bincount of its index map")

    pred = synth_spectra(rng, 8, n)
    true = pred * rng.uniform(0.7, 1.3, (8, 1)).astype(np.float32) + synth_spectra(rng, 8, n, n_peaks=2) * 0.3
    got = diffraction_metrics_device(torch.from_numpy(pred).cuda(), torch.from_numpy(true).cuda(), d_centers_hr)
    host = peak_matching_loss(find_peaks_for_batch([{"d": qw.centers, "I": p} for p in pred]),
                              find_peaks_for_batch([{"d": qw.centers, "I": t} for t in true]))
    worst = 0.0
    for key, want_k in host.items():
        g, w = got[key].cpu().numpy(), np.asarray(want_k)
        worst = max(worst, float(np.max(np.abs(g - w) / (METRIC_TOL + METRIC_TOL * np.abs(w)))))
    zero = torch.zeros(2, n).cuda()
    same = diffraction_metrics_device(torch.from_numpy(pred[:2]).cuda(), torch.from_numpy(pred[:2]).cuda(), d_centers_hr)
    empty = diffraction_metrics_device(zero, zero, d_centers_hr)
    zeros_ok = all(float(same[k].abs().max()) <= 1e-6 and float(empty[k].abs().max()) == 0.0 for k in host)
    matched = int((np.asarray(host["Integral Intensity"]) > 0).sum())
    ok = worst <= 1.0 and zeros_ok and matched == 8
    print(f"  diffraction_metrics_device, 8 pairs of synthesized spectra, against the host scipy oracle: worst "
          f"{worst:.2e} of rtol = atol = {METRIC_TOL:.0e}, {matched}/8 pairs matched; identical and empty spectra "
          f"give 0: {zeros_ok} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("physics: the device metrics disagree with the host oracle")

    # alone, at the RL reward's shapes: the pred [4, 1, 500, 960] and true
    # [4, 1, 250, 480] rebins, and the metrics on [4, 1241] pairs
    hr = torch.from_numpy(rng.uniform(0, 1e3, (RL_B, 1, 2 * H, 2 * W)).astype(np.float32)).cuda()
    idx_hr = torch.from_numpy(qw._indices_for(2 * H, 2 * W)).cuda()
    out = torch.zeros(RL_B, n + 1).cuda()
    flat = hr.reshape(RL_B, -1)
    p4, t4 = torch.from_numpy(pred[:RL_B]).cuda(), torch.from_numpy(true[:RL_B]).cuda()
    return {
        f"rebin [{RL_B}, 1, {2 * H}, {2 * W}] (segment sums)": cuda_ms(lambda: qw.rebin(hr), 20),
        f"the same by index_add_ (atomics)": cuda_ms(lambda: out.zero_().index_add_(1, idx_hr, flat), 20),
        f"metrics on [{RL_B}, {n}] pairs": cuda_ms(lambda: diffraction_metrics_device(p4, t4, d_centers_hr), 5),
    }


def rl_policy(device="cuda"):
    return AlphaPolicy(device=device, generator=torch.Generator().manual_seed(SEED + 1))


def rl_model(negate=True):
    """The fine-tune's model: build_model's fp32 weights from RL_SEED, with
    the upscaler's output layer negated. The draw as it comes gives an SR
    output below 0 in most pixels and anti-correlated with its target, so
    its rollout has few peaks or none (rollout_lines counts them) and the
    reward was 0 in every step; negated, it is as likely a draw of the same
    distribution, and its rollout has peaks."""
    model = build_model(torch.float32, seed=RL_SEED).train()
    if negate:
        with torch.no_grad():
            out = model.upscaler_head.reconstruction[2]
            out.weight.neg_()
            out.bias.neg_()
    return model


def rollout_peaks(model, policy, images):
    """d-spacings at which the reward's rollout of `images` (upscale,
    apply_action at mu, denormalize, rebin of channel 0) has peaks that
    pass the reward's gates, over the batch."""
    qw = Qwrapper(fixed_centers=d_centers_hr)
    with torch.no_grad(), plain_blocks():
        _, norm_lr, _, params_hr, skips = rl_mod.rl_preprocess(model, images)
        mu, _ = policy(norm_lr)
        sr, _ = model.upscale(norm_lr, skips)
        spec = qw.rebin(denormalize_piecewise(apply_action(sr.float(), mu), params_hr)[:, 0:1])
        pk = peaks_mod.find_peaks_device(spec)
    return np.unique(qw.centers[pk["idx"][pk["valid"]].cpu().numpy()])


def rollout_lines(rng):
    """The d-spacings of rl_model's rollout peaks on Bragg patterns: patterns
    with lines there give those peaks a true peak to match, so that the
    reward is not 0."""
    images = torch.from_numpy(bragg_patterns(rng, RL_B)).cuda()
    as_drawn = rollout_peaks(rl_model(negate=False), rl_policy(), images)
    lines = rollout_peaks(rl_model(), rl_policy(), images)
    print(f"  the rollout's peaks on [{RL_B}, 2, {H}, {W}] Bragg patterns: {len(as_drawn)} with the weights as "
          f"drawn, {len(lines)} with the output layer negated (rl_model), at d = "
          f"{[round(float(d), 3) for d in lines]} A; the fine-tune's patterns get lines there")
    if len(lines) == 0:
        raise SystemExit("RL: the rollout has no peak to match")
    return lines


def rl_stage_check(got, plain, quiet=False):
    """Every RL-serving stage and alpha in `got` against the plain route's
    (bf16 PIPE_TOL; upscaled_norm's mean at RL_UPSCALED_MEAN_TOL): returns
    the stages that fail, and upscaled_norm's mean error over its
    tolerance."""
    failed, ratio = [], 0.0
    tol_max = PIPE_TOL[torch.bfloat16][0]
    for k, b in plain.items():
        a, b = got[k].float(), b.float()
        tol_mean = RL_UPSCALED_MEAN_TOL if k == "upscaled_norm" else PIPE_TOL[torch.bfloat16][1]
        scale = 1.0 if k.startswith("seg") else max(b.abs().max().item(), 1e-30)
        err, mean = (a - b).abs().max().item(), (a - b).abs().mean().item()
        ok = bool(torch.isfinite(a).all()) and err <= tol_max * scale and mean <= tol_mean * scale
        if k == "upscaled_norm":
            ratio = mean / (tol_mean * scale)
        if not quiet:
            print(f"  RL {k:17s} {str(tuple(a.shape)):22s} kernel vs plain: max_abs={err:.3e} (tol "
                  f"{tol_max * scale:.3e}) mean_abs={mean:.3e} (tol {tol_mean * scale:.3e}) {'ok' if ok else 'FAIL'}")
        if not ok:
            failed.append(k)
    return failed, ratio


def rl_serve(rng, n_calls=3):
    """RLInference at bf16 on [RL_B, 2, 250, 480] Bragg patterns: every
    stage and alpha against the plain route (rl_stage_check), and a control
    that must fail it; launches per call against the gate. Returns
    (per-call ms, plain ms, launches in the run)."""
    bf16 = torch.bfloat16
    infer = RLInference(build_model(bf16), rl_policy())
    requests = [bragg_patterns(rng, RL_B) for _ in range(n_calls)]
    infer(requests[0])  # warm-up
    torch.cuda.synchronize()
    names = STAGE_NAMES + ("alpha",)
    sb.reset_counts()
    per_call, call_ms, first = [], [], None
    for req in requests:
        before = launches()
        t0 = time.perf_counter()
        infer(req)
        torch.cuda.synchronize()
        call_ms.append((time.perf_counter() - t0) * 1e3)
        per_call.append([b - a for a, b in zip(before, launches())])
        if first is None:
            first = {k: getattr(infer, k).clone() for k in names}
    total = launches()
    with plain_blocks():
        infer(requests[0])
        torch.cuda.synchronize()
        plain = {k: getattr(infer, k).clone() for k in names}
        t0 = time.perf_counter()
        infer(requests[0])
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
    want = expected_launches("serve", RL_B, bf16, False, "cmajor")
    if launches() != total or any(n != want for n in per_call):
        raise SystemExit(f"RL serving: launches per call {per_call} (gate: {want}), or the plain route launched")
    failed, _ = rl_stage_check(first, plain)
    if failed:
        raise SystemExit(f"RL serving: {failed} disagree with the plain route or are not finite")
    # a control: the first request again with every cst launch ignoring its
    # pad mask (a fault of the padded levels) must fail that comparison
    call = sb._kernel_call
    sb._kernel_call = lambda layout, nH, x, mask, *w: call(layout, nH, x, None if layout == "cmajor" else mask, *w)
    try:
        infer(requests[0])
        torch.cuda.synchronize()
    finally:
        sb._kernel_call = call
    caught, ratio = rl_stage_check({k: getattr(infer, k) for k in names}, plain, quiet=True)
    print(f"  control, every cst launch without its pad mask: fails at {caught}; upscaled_norm's mean error "
          f"{ratio:.2f}x its tolerance {'ok' if caught else 'FAIL'}")
    if not caught:
        raise SystemExit("RL serving: the stage comparison does not catch a dropped pad mask")
    print(f"  RL serving launches per call [cst, row-major, wide] {per_call} (gate: {want}); alpha "
          f"{[round(v, 4) for v in first['alpha'].flatten().tolist()]}")
    profile_call(lambda: infer(requests[0]), "one RL serving call")
    return call_ms, plain_ms, total


RL_METRICS = ("reward", "policy_loss", "rec", "sup_loss")


def rl_first_step(images, noise, plain):
    """One fp32 RL step from rl_model's weights; returns (metrics, gradients
    of the model and the policy by name, launches)."""
    model = rl_model()
    policy = rl_policy()
    model_opt = masked_adamw(model, "rl", 1e-5, weight_decay=0.0)
    policy_opt = AdamW(policy.parameters(), 1e-4, weight_decay=0.0)
    before = launches()
    with plain_blocks() if plain else contextlib.nullcontext():
        m = rl_step(model, policy, model_opt, policy_opt, Qwrapper(fixed_centers=d_centers_hr), images, noise)
    torch.cuda.synchronize()
    grads = {k: p.grad.clone() for k, p in model.named_parameters() if p.grad is not None}
    grads.update({f"policy.{k}": p.grad.clone() for k, p in policy.named_parameters()})
    return {k: float(v) for k, v in m.items()}, grads, [b - a for a, b in zip(before, launches())]


def compare_rl_first_steps(rng, lines):
    """The first fp32 RL step through the kernels against the same step
    through the plain versions, with compare_first_steps' tolerances, after
    checking that on both routes the reward and every policy gradient are
    not 0."""
    images = torch.from_numpy(bragg_patterns(rng, RL_B, lines)).cuda()
    noise = torch.randn((RL_B, 1), generator=torch.Generator().manual_seed(SEED)).cuda()
    m_k, grads_k, n_k = rl_first_step(images, noise, plain=False)
    m_p, grads_p, n_p = rl_first_step(images, noise, plain=True)
    want = expected_launches("rl", RL_B, torch.float32, False, "cmajor")
    live = {route: m["reward"] != 0 and all(g[k].abs().max().item() > 0 for k in g if k.startswith("policy."))
            for route, m, g in (("kernel", m_k, grads_k), ("plain", m_p, grads_p))}
    print(f"  RL first step, fp32: reward and every policy gradient not 0 on the kernel route {live['kernel']}, "
          f"on the plain route {live['plain']}")
    if not all(live.values()):
        raise SystemExit("RL: the first step's reward or a policy gradient is 0, so the comparison shows nothing")
    worst, worst_name = 0.0, ""
    for k, g in grads_p.items():
        scale = g.abs().max().item()
        if scale == 0:
            if grads_k[k].abs().max().item() != 0:
                worst, worst_name = float("inf"), f"{k} (zero on the plain route only)"
            continue
        rel = (grads_k[k] - g).abs().max().item() / scale
        tol = TRAIN_SCALAR_GRAD_TOL if g.numel() == 1 else TRAIN_GRAD_TOL
        if rel / tol > worst:
            worst, worst_name = rel / tol, f"{k} ({rel:.2e} of its max, tol {tol:.0e})"
    rel = {k: abs(m_k[k] - m_p[k]) / abs(m_p[k]) if m_p[k] else abs(m_k[k]) for k in RL_METRICS}
    ok = (all(np.isfinite(v) for v in m_k.values()) and max(rel.values()) <= TRAIN_LOSS_RTOL and worst <= 1.0
          and n_k == want and n_p == [0, 0, 0] and grads_k.keys() == grads_p.keys())
    print(f"  RL first step, fp32: " + ", ".join(f"{k} {m_k[k]:.6g} vs plain {m_p[k]:.6g}" for k in RL_METRICS)
          + f" (worst rel {max(rel.values()):.1e}, tol {TRAIN_LOSS_RTOL:.0e}); integral {m_k['integral']:.4g}, "
          f"peak {m_k['peak']:.4g}, shape {m_k['shape']:.4g}; {len(grads_k)} gradients, worst {worst_name}; "
          f"launches {n_k} (gate: {want}), plain route {n_p} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("RL: the first step disagrees with the plain route")


def rl_main_path(rng, lines, n_steps=4):
    """RLTrainer over one epoch of n_steps [RL_B, 2, 250, 480] batches in
    bf16 (scripts/rl_run.py's batch and dtype), the reward's parts timed by
    CUDA events. Returns (per-step ms, reward ms, distance-gate ms, ranks
    the gate looped, launches in the run, peak GiB)."""
    model = rl_model()
    policy = rl_policy()
    loader = ProbeLoader([(bragg_patterns(rng, RL_B, lines),) for _ in range(n_steps)], model)
    trainer = RLTrainer(model, policy, loader, num_epochs=1, compute_dtype=torch.bfloat16, seed=SEED, verbose=False)
    rewards, train_step = [], trainer.train_step

    def step_noting_reward(images):
        m = train_step(images)
        rewards.append(float(m["reward"]))
        return m

    trainer.train_step = step_noting_reward
    timer, ranks = EventTimer(), []
    enforce = peaks_mod._enforce_distance

    def gate(mask, I, distance):
        out = timed_gate(mask, I, distance)
        ranks.append(int(mask.sum(1).max()))
        return out

    timed_gate = timer.wrap("gate", enforce)
    orig = (Qwrapper.rebin, rl_mod.diffraction_metrics_device)
    Qwrapper.rebin = timer.wrap("rebin", Qwrapper.rebin)
    rl_mod.diffraction_metrics_device = timer.wrap("metrics", rl_mod.diffraction_metrics_device)
    peaks_mod._enforce_distance = gate
    torch.cuda.reset_peak_memory_stats()
    sb.reset_counts()
    try:
        metrics = trainer.train_epoch()
        torch.cuda.synchronize()
    finally:
        Qwrapper.rebin, rl_mod.diffraction_metrics_device = orig
        peaks_mod._enforce_distance = enforce
    total = launches()
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    if not all(np.isfinite(v) for v in metrics.values()):
        raise SystemExit(f"RL: a metric is not finite: {metrics}")
    check_frozen("rl", loader.epochs[0]["params"], snapshot(model))
    steps = loader.steps(0)
    want = expected_launches("rl", RL_B, torch.bfloat16, False, "cmajor")
    if len(steps) != n_steps or any(n != want for _, n in steps):
        raise SystemExit(f"RL: launches per step {[n for _, n in steps]}, the gate implies {want}")
    if trainer.policy_opt.count != n_steps or trainer.model_opt.count != n_steps:
        raise SystemExit("RL: the policy's or the model's step count did not advance once a step")
    if 0.0 in rewards:
        raise SystemExit(f"RL: a step's reward is 0: {rewards}")
    rebin, met, dist = timer.ms("rebin"), timer.ms("metrics"), timer.ms("gate")
    reward_ms = [rebin[2 * i] + rebin[2 * i + 1] + met[i] for i in range(n_steps)]
    print(f"  RL bf16 B={RL_B}: {n_steps} steps, launches per step [cst, row-major, wide] {[n for _, n in steps]} "
          f"(gate: {want}); policy steps {trainer.policy_opt.count}; rewards {[round(r, 4) for r in rewards]}; "
          f"epoch metrics "
          + " ".join(f"{k}={v:.4g}" for k, v in metrics.items()))
    print(f"  RL ms per step {[round(ms, 1) for ms, _ in steps]}; of which the reward (2 rebins + metrics) "
          f"{[round(t, 2) for t in reward_ms]}, the distance gate {[round(t, 2) for t in dist]} over "
          f"{ranks} candidate ranks; peak device memory {peak_gb:.2f} GiB")
    images = loader.batches[1][0]
    profile_call(lambda: train_step(images), f"one RL step, bf16, B={RL_B}")
    return [ms for ms, _ in steps], reward_ms, dist, ranks, total, peak_gb


def plan_text(C, nH, dtype, round_qkv=True):
    """A launch's plan, which body it takes, its registers and CTAs an SM."""
    p = sb.kernel_plan(C, nH, dtype, round_qkv)
    regs, ctas = sb.kernel_info(C, nH, dtype, round_qkv)
    body = ("fp32-FMA body", "tensor cores, two weight slots", "tensor cores, weights resident")[p.body]
    rows = f"{p.mp} rows padded" if p.body else f"tile {p.KC}x{p.OT} 5x{p.CN} a thread"
    planned = f" (planned {p.min_ctas})" if p.body else ""
    return (f"{body}: WB={p.WB} G={p.G} HC={p.HC} {rows}, {p.smem_bytes} B shared, {regs} registers, "
            f"{ctas} CTAs an SM{planned}")


def time_levels(dtype, gen):
    """Per level at B=4: kernel ms (both layouts), plain ms, bound ms.
    Returns the sums over one pipeline call's launches."""
    tot = {"ms": 0.0, "plain_ms": 0.0, "flops": 0, "bytes": 0}
    for name, C, nH, grid, per_call in LEVELS:
        xt, args, mask = level_args(C, nH, grid, B, dtype, gen)
        x_tok, x_cm = xt.permute(2, 1, 0), xt.permute(2, 1, 0).contiguous()
        k_tok = cuda_ms(lambda: sb.fused_swin_block_cst(x_tok, *args, num_heads=nH, pad_mask=mask), 20)
        k_cm = cuda_ms(lambda: sb.fused_swin_block_cst(x_cm, *args, num_heads=nH, pad_mask=mask), 20)
        p_ms = cuda_ms(lambda: sb.swin_block_plain(x_tok, *args, num_heads=nH, pad_mask=mask), 5)
        flops, nbytes = block_cost(C, nH, x_tok.shape[2], dtype, mask is not None)
        t_ops, t_bytes = flops / PEAK_OPS[dtype] * 1e3, nbytes / HBM_BPS * 1e3
        print(f"  cst  {name:13s} C={C:3d} nH={nH:2d} Wt={x_tok.shape[2]:6d} x{per_call}/call  "
              f"kernel token-major {k_tok:.4f} ms  channels-major {k_cm:.4f} ms  plain {p_ms:.4f} ms  "
              f"bound {max(t_ops, t_bytes):.4f} ms by {'operations' if t_ops > t_bytes else 'bytes'}  "
              f"({plan_text(C, nH, dtype)})")
        tot["ms"] += per_call * k_tok
        tot["plain_ms"] += per_call * p_ms
        tot["flops"] += per_call * flops
        tot["bytes"] += per_call * nbytes
    return tot


def time_new_levels(kernel, dtype, batch, levels, gen):
    """Per on-path shape of the row-major or the wide kernel at `batch`:
    kernel ms, plain ms, bound ms. `levels` rows end in the launches per
    step or call; returns the sums over those launches."""
    tot = {"ms": 0.0, "plain_ms": 0.0, "flops": 0, "bytes": 0}
    for name, C, nH, grid, per in levels:
        xt, args, mask_nw = level_args(C, nH, grid, batch, dtype, gen)
        args = in_out_args(args)
        if kernel == "row":
            x = xt.reshape(-1, C)
            mask = None if mask_nw is None else mask_nw.t().reshape(-1, 1)
            k_ms = cuda_ms(lambda: sb.fused_swin_block(x, *args, num_heads=nH, pad_mask=mask), 10)
            p_ms = cuda_ms(lambda: sb.swin_block_rowmajor_plain(x, *args, num_heads=nH, pad_mask=mask), 3)
            # the same launch with the matrices stored [in, out] (a warp reads a
            # weight row of consecutive outputs) instead of nn.Linear's [out, in]
            stored_io = [a.contiguous() if i in (2, 5, 9, 11) else a for i, a in enumerate(args)]
            io_ms = cuda_ms(lambda: sb.fused_swin_block(x, *stored_io, num_heads=nH, pad_mask=mask), 10)
            plan = sb.kernel_plan(C, nH, dtype)
            extra = (f"  ([in, out]-stored weights {io_ms:.4f} ms; plan WB={plan.WB} G={plan.G} HC={plan.HC} "
                     f"tile {plan.KC}x{plan.OT} 5x{plan.CN} a thread, {plan.threads} threads, "
                     f"{plan.smem_bytes} B shared)")
        else:
            x, mask = xt.transpose(0, 1).contiguous(), None
            k_ms = cuda_ms(lambda: sb.fused_swin_block_wide(x, *args, num_heads=nH), 10)
            p_ms = cuda_ms(lambda: sb.swin_block_wide_plain(x, *args, num_heads=nH), 3)
            extra = f"  ({plan_text(C, nH, dtype)})"
        flops, nbytes = block_cost(C, nH, xt.shape[0], dtype, mask is not None)
        t_ops, t_bytes = flops / PEAK_OPS[dtype] * 1e3, nbytes / HBM_BPS * 1e3
        print(f"  {kernel:4s} {name:13s} C={C:3d} nH={nH:2d} Wt={xt.shape[0]:6d} {str(dtype)[6:]:8s} x{per}  "
              f"kernel {k_ms:.4f} ms  plain {p_ms:.4f} ms  "
              f"bound {max(t_ops, t_bytes):.4f} ms by {'operations' if t_ops > t_bytes else 'bytes'}{extra}")
        tot["ms"] += per * k_ms
        tot["plain_ms"] += per * p_ms
        tot["flops"] += per * flops
        tot["bytes"] += per * nbytes
    return tot


def kernel_record(name, replaces, n_launches, max_abs_err, tot, dtype):
    bound_ops, bound_bytes = tot["flops"] / PEAK_OPS[dtype] * 1e3, tot["bytes"] / HBM_BPS * 1e3
    return {
        "name": name,
        "route": "cuda",
        "source": "swinwnet_tpu_torch/ops/csrc/swin_block.cu",
        "replaces": replaces,
        "launches": n_launches,
        "max_abs_err": max_abs_err,
        "ms": tot["ms"],
        "plain_ms": tot["plain_ms"],
        "bound_ms": max(bound_ops, bound_bytes),
        "bound_by": "operations" if bound_ops > bound_bytes else "bytes",
        "library_ms": None,  # no single PyTorch call computes a whole Swin block
    }


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("TF32 off: torch.backends.cuda.matmul.allow_tf32 = False, torch.backends.cudnn.allow_tf32 = False")
    print("torch", torch.__version__, "cuda", torch.version.cuda, "device", torch.cuda.get_device_name(0))
    t_start = time.perf_counter()

    lib = sb.build(verbose=True)
    print(f"[1] built {lib.name} in {time.perf_counter() - t_start:.2f} s")
    check_sass(lib)

    gen = torch.Generator().manual_seed(SEED)
    bf16, fp32 = torch.bfloat16, torch.float32
    print("[2] kernels against their plain versions")
    err_cst = {dt: check_kernel(dt, gen) for dt in (bf16, fp32)}
    err_row = {dt: check_rowmajor(dt, gen) for dt in (bf16, fp32)}
    err_wide = {dt: check_wide(dt, gen) for dt in (bf16, fp32)}
    err_tc = check_tensor_cores(gen)
    err_cst[bf16] = max(err_cst[bf16], err_tc["cst"])
    err_wide[bf16] = max(err_wide[bf16], err_tc["wide"])
    check_gradients(gen)

    rng = np.random.default_rng(SEED)
    main_path = [0, 0, 0]  # launches per kernel over the main paths this script drives
    print(f"[3] serving, bf16, 3 requests of [{B}, 2, {H}, {W}]")
    stages, call_ms, per_call, total, plain, plain_ms = serve(bf16, B, 3, rng, profile=True)
    print(f"  kernel launches per call [cst, row-major, wide] {per_call} (total {total})")
    want = expected_launches("serve", B, bf16, False, "cmajor")
    if want != [LAUNCHES_PER_CALL[bf16], 0, 0]:
        raise SystemExit(f"the gate's count {want} is not LAUNCHES_PER_CALL")
    check_pipeline(bf16, B, stages, plain, per_call, want)
    main_path = add(main_path, total)
    print("[3] serving, fp32, 2 requests of [1, 2, 250, 480]")
    s32, ms32, pc32, _, p32, pms32 = serve(fp32, 1, 2, rng)
    print(f"  kernel launches per call {pc32}")
    want = expected_launches("serve", 1, fp32, False, "cmajor")
    if want != [LAUNCHES_PER_CALL[fp32], 0, 0]:
        raise SystemExit(f"the gate's count {want} is not LAUNCHES_PER_CALL")
    check_pipeline(fp32, 1, s32, p32, pc32, want)

    print(f"[4] training, fp32, fused_blocks and fused_deep, batches of [{TRAIN_B}, 2, {H}, {W}]")
    batch = training_batches(1, TRAIN_B, rng)[0]
    for kind in ("stage1", "stage2", "stage3_even", "stage3_odd"):
        compare_first_steps(kind, batch, fused_deep=True)
    step_ms, total = train_main_path(rng)
    main_path = add(main_path, total)

    print("[5] the wide kernel's path: fused_layout='nmajor'")
    compare_first_steps("stage1", batch, fused_deep=True, fused_layout="nmajor")
    sb.reset_counts()
    loss, _, n_step = first_step("stage1", batch, plain=False, fused_deep=True, fused_layout="nmajor")
    if not np.isfinite(loss):
        raise SystemExit("nmajor stage-1 step: loss not finite")
    sw, ms_w, pc_w, total_w, pw, pms_w = serve(bf16, B, 1, rng, fused_layout="nmajor")
    want = expected_launches("serve", B, bf16, False, "nmajor")
    print(f"  stage-1 step launches {n_step}; bf16 serving call launches {pc_w} (gate: {want}; encoder L1, "
          f"63x120, does not tile and runs the unfused blocks)")
    check_pipeline(bf16, B, sw, pw, pc_w, want)
    main_path = add(main_path, n_step, total_w)

    print("[6] the d-space physics on the card")
    phys_ms = check_physics(rng)
    print(f"[7] RL serving, bf16, 3 requests of [{RL_B}, 2, {H}, {W}] synthesized Bragg patterns")
    rl_call_ms, rl_plain_ms, total = rl_serve(rng)
    main_path = add(main_path, total)
    print(f"[8] the REINFORCE fine-tune, batches of [{RL_B}, 2, {H}, {W}] synthesized Bragg patterns")
    lines = rollout_lines(rng)
    compare_rl_first_steps(rng, lines)
    rl_ms, reward_ms, gate_ms, ranks, total, rl_peak_gb = rl_main_path(rng, lines)
    main_path = add(main_path, total)
    if min(main_path) == 0:
        raise SystemExit(f"a kernel was launched no time on the main paths: {main_path}")
    if expected_launches("rl", RL_B, bf16, False, "cmajor")[0] != (
            expected_launches("stage1", RL_B, bf16, False, "cmajor")[0] + sum(r[4] for r in RL_LEVELS)):
        raise SystemExit("RL_LEVELS are not the shapes of the RL step's upscale launches")

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"[9] times on {smi}")
    mean_ms = float(np.mean(call_ms))
    wall, busy = PROFILES["one serving call"]
    print(f"  serving bf16 B={B}: per call {', '.join(f'{t:.1f}' for t in call_ms)} ms (mean {mean_ms:.1f} ms, "
          f"{B / mean_ms * 1e3:.2f} images/s); through the plain versions {plain_ms:.1f} ms; under the profiler "
          f"the device was busy {busy:.1f} of {wall:.1f} ms ({100 * busy / wall:.1f}%)")
    print(f"  serving fp32 B=1: per call {', '.join(f'{t:.1f}' for t in ms32)} ms; through the plain versions {pms32:.1f} ms")
    print(f"  serving bf16 B={B} with fused_layout='nmajor': {ms_w[0]:.1f} ms; through the plain versions {pms_w:.1f} ms")
    for kind, ms in step_ms.items():
        warm = ms[1:] if len(ms) > 1 else ms
        print(f"  training fp32 B={TRAIN_B} {kind}: ms per step {[round(t, 1) for t in ms]}, "
              f"after the stage's first step {float(np.mean(warm)):.1f} ms")
    warm = lambda ts: float(np.mean(ts[1:]))
    print(f"  RL fine-tune bf16 B={RL_B}: ms per step {[round(t, 1) for t in rl_ms]}, after the first "
          f"{warm(rl_ms):.1f} ms; of which the reward (2 rebins + metrics) {warm(reward_ms):.2f} ms and the "
          f"distance gate {warm(gate_ms):.2f} ms ({ranks} ranks); peak device memory {rl_peak_gb:.2f} GiB")
    print(f"  RL serving bf16 B={RL_B}: per call {', '.join(f'{t:.1f}' for t in rl_call_ms)} ms (mean "
          f"{float(np.mean(rl_call_ms)):.1f} ms); through the plain versions {rl_plain_ms:.1f} ms")
    print("  physics alone: " + "; ".join(f"{k} {v:.4f} ms" for k, v in phys_ms.items()))
    tot_cst = time_levels(bf16, gen)
    print(f"  cst: one bf16 serving call's {LAUNCHES_PER_CALL[bf16]} launches: kernel {tot_cst['ms']:.3f} ms, "
          f"plain {tot_cst['plain_ms']:.3f} ms")
    # the row-major kernel over one stage-1 step (fp32, B = TRAIN_B): two
    # launches a level, the bottleneck sharing encoder L3's signature
    row_levels = [(n, C, nH, g, 4 if n == "encoder L3" else 2) for n, C, nH, g, _ in ROW_LEVELS]
    tot_row = time_new_levels("row", fp32, TRAIN_B, row_levels, gen)
    print(f"  row-major: one fp32 stage-1 step's {sum(r[4] for r in row_levels)} launches: kernel "
          f"{tot_row['ms']:.3f} ms, plain {tot_row['plain_ms']:.3f} ms")
    # the wide kernel over one bf16 serving call with fused_layout="nmajor"
    # (B = 4): L0 in two encoders and three passes, the decoder's last stage
    # in three, the SR levels once
    wide_levels = [(n, C, nH, g, {48: 6, 96: 6, 24: 2, 12: 2}[C]) for n, C, nH, g in WIDE_LEVELS]
    tot_wide = time_new_levels("wide", bf16, B, wide_levels, gen)
    print(f"  wide: one bf16 nmajor serving call's {sum(r[4] for r in wide_levels)} launches: kernel "
          f"{tot_wide['ms']:.3f} ms, plain {tot_wide['plain_ms']:.3f} ms")
    # and at the one shape an fp32 nmajor stage-1 step gives it (encoder L0, twice)
    time_new_levels("wide", fp32, TRAIN_B, [(*r[:4], 2) for r in wide_levels if r[1] == 48], gen)
    if sum(r[4] for r in wide_levels) != pc_w[0][2] or sum(r[4] for r in row_levels) != expected_launches(
            "stage1", TRAIN_B, fp32, True, "cmajor")[1]:
        raise SystemExit("the timed launches are not those of the path")
    print(f"  whole script {time.perf_counter() - t_start:.0f} s")

    print(json.dumps({"kernels": [
        kernel_record("fused_swin_block_cst", "swinwnet_tpu/ops/pallas/swin_block.py:479",
                      main_path[0], err_cst[bf16], tot_cst, bf16),
        kernel_record("fused_swin_block", "swinwnet_tpu/ops/pallas/swin_block.py:73",
                      main_path[1], err_row[fp32], tot_row, fp32),
        kernel_record("fused_swin_block_wide", "swinwnet_tpu/ops/pallas/swin_block.py:309",
                      main_path[2], err_wide[bf16], tot_wide, bf16),
    ]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
