#!/usr/bin/env python3
"""Build and drive the PyTorch port (swinwnet_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

1. builds the fused Swin-block kernels (ops/csrc/swin_block.cu) with nvcc and
   checks in its SASS (cuobjdump) that the tensor-core body has HMMA
   instructions and the fp32-FMA body none;
2. holds each kernel against its plain PyTorch version on the card, in bf16
   and fp32: `fused_swin_block_cst` at the five shapes the serving pipeline
   gives it (token-major and channels-major), `fused_swin_block` (row-major)
   at every signature the gate sends to it with fused_deep in fp32 and with
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
6. times: per call (with the serving call's device-busy share), per
   training step, and per kernel and on-path shape the kernel, its plain
   version and its bound; for cst and wide the plan, the body it takes, its
   registers and CTAs an SM; for the row-major kernel also the same launch
   with [in, out]-stored weights and the plan of its CTAs.

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

from swinwnet_tpu_torch.models import SwinWNet
from swinwnet_tpu_torch.ops import swin_block as sb
from swinwnet_tpu_torch.ops.window import window_pad_mask_np
from swinwnet_tpu_torch.pipelines import STAGE_NAMES, SwinWNetInference
from swinwnet_tpu_torch.train import (
    FullModelTrainer,
    SegmentatorTrainer,
    SwinWNetTrainingPipeline,
    UpscalerTrainer,
)

SEED = 0
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
ODD_WINDOWS = 1201  # a prime: no count of windows per CTA divides it
# first training step, kernel route against plain route (fp32): the two
# forwards differ by summation order (~3e-7 relative per block) and the two
# backwards are the same fp32 reference on inputs that differ that little,
# so the loss agrees to 1e-5 relative and each parameter's gradient to
# 1e-3 of its largest element; a one-element leaf (a cross-attention gamma)
# is a sum of products of either sign that nearly cancel, and gets 2e-2
TRAIN_LOSS_RTOL, TRAIN_GRAD_TOL, TRAIN_SCALAR_GRAD_TOL = 1e-5, 1e-3, 2e-2


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
    """Launches per kernel of one serving call or one training step, from
    the gate: segment_1 and segment_2 are tower passes on the 250x480 token
    source, upscale is a tower pass with the SR head; stage 2 and the even
    step of stage 3 upscale the half-size image."""
    tower = lambda hw, head: tower_launches(hw, batch, dtype, fused_deep, layout, head)
    seg, up_full, up_half = tower((H, W), False), tower((H, W), True), tower((H // 2, W // 2), True)
    return {
        "serve": add(seg, up_full, seg),
        "stage1": seg,
        "stage2": add(seg, up_half),
        "stage3_even": add(seg, up_half),
        "stage3_odd": add(seg, up_full, seg),
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
    """`fused_swin_block_cst` against plain at the five on-path shapes (B=1)
    and at a window count no CTA size divides; returns the largest absolute
    error."""
    worst = 0.0
    for name, C, nH, grid, _ in LEVELS + [("odd count", 48, 3, (5, 5 * ODD_WINDOWS), 0)]:
        xt, args, mask = level_args(C, nH, grid, 1, dtype, gen)
        for layout, x in (("token-major", xt.permute(2, 1, 0)), ("channels-major", xt.permute(2, 1, 0).contiguous())):
            out = sb.fused_swin_block_cst(x, *args, num_heads=nH, pad_mask=mask)
            torch.cuda.synchronize()
            ref = sb.swin_block_plain(x, *args, num_heads=nH, pad_mask=mask)
            tag = f"cst  {name:13s} C={C:3d} nH={nH:2d} Wt={x.shape[2]:6d} mask={mask is not None!s:5s} {layout:14s}"
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


def build_model(dtype, **kw):
    gen = torch.Generator().manual_seed(SEED)
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
    if min(main_path) == 0:
        raise SystemExit(f"a kernel was launched no time on the main paths: {main_path}")

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"[6] times on {smi}")
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
