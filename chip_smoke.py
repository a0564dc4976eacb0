#!/usr/bin/env python3
"""Build and drive the PyTorch port (swinwnet_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

1. builds the fused Swin-block kernels (ops/csrc/swin_block.cu) with nvcc and
   checks in its SASS (cuobjdump) that every instance of the Hopper body has
   wgmma (HGMMA) and a TMA or bulk-copy load (UTMALDG, UBLKCP), every one of
   the narrow body mma.sync (HMMA) and no wgmma, and the fp32-FMA body none
   of these;
2. holds each kernel against its plain PyTorch version on the card, in bf16
   and fp32: `fused_swin_block_cst` at the five shapes the serving pipeline
   gives it, the five the RL step's half-size upscale gives it at B=4
   (every grid padded) and SwinUNet's at B=64 (in fp32 the one the gate
   sends it), token-major and channels-major; `fused_swin_block`
   (row-major) at every signature the gate sends to it with fused_deep in fp32 and with
   one window, one fewer and one more than a CTA takes,
   `fused_swin_block_wide` at its four on-path shapes, each also at a window
   count no CTA size divides; the bf16 tensor-core bodies of cst and wide
   (the narrow body at C <= 24, the Hopper body above) at every on-path
   shape with all weights stored [out, in] and all [in, out], at one window
   fewer, as many and one more than a batch, at a count whose ragged last
   batch is the second its persistent CTA or warp takes, and with the
   output over the input; and the differentiable block's gradients
   against autograd through the plain fp32 reference, per layout; then
   `patch_expand_norm` (PatchExpanding's shuffle and LayerNorm,
   ops/csrc/expand_norm.cu) against `patch_expand_norm_plain` at the five
   shapes the serving pipeline gives it (C/2 = 192 down to 12), B=1 and
   B=64, in bf16 within one bf16 ulp of the plain value; and
   `window_attention` (the unfused levels' window attention,
   ops/csrc/window_attention.cu) against `window_attention_plain` at the
   four shapes the serving pipeline gives it (C/heads 384/24, 192/12,
   384/12, 192/6), B=1 and B=64, in bf16 within the rounding bound of its
   probabilities (attention_bound), one launch counted a call;
3. serving: three [4, 2, 250, 480] requests through SwinWNetInference at the
   published width (embed 48, depths 2-2-2-2, heads 3-6-12-24, window 5) in
   bf16, random weights from a seed, live cross-attention; counts the
   kernel's launches (22 per call), the expansions' (11 per call) and the
   window attention's (30 per call; the counters zeroed before the calls)
   and that the plain route launches none of them, checks the 8 stage tensors, compares
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
   as a captured program against itself run eagerly, bit for bit;
   `diffraction_metrics_device` on 8 pairs of synthesized spectra against
   the host scipy oracle; identical and empty spectra give 0;
7. RL serving: three [4, 2, 250, 480] requests of synthesized Bragg
   patterns through RLInference in bf16, every stage and alpha against the
   plain route, 22 cst launches and 30 window attention launches a call;
8. the REINFORCE fine-tune, on a model whose rollout has peaks (rl_model)
   and Bragg patterns with lines where they are, so that the reward is not
   0: the first RL step in fp32 against the same step on the plain route
   (reward and policy gradients not 0 on both; reward, losses, gradients),
   then RLTrainer for 4
   steps in bf16 at [4, 2, 250, 480] (scripts/rl_run.py's batch and dtype)
   with launches per step against the gate, every step's reward not 0, the frozen parameters
   unchanged bit for bit, and the reward and distance-gate times by CUDA
   events around the functions, so its step program runs eagerly here
   (`core.graphs.run_eagerly`; [22] holds the program against it);
9. fp32 at full fp32: under the TF32 flags as found (the script sets none;
   PyTorch's default lets cuDNN use TF32) and with TF32 switched on, the
   fp32 patch embedding and segmentation head at the published width agree
   with float64 within 1e-5 of their max; the control, the same check with
   the port's `full_fp32` made a no-op and TF32 on, must fail;
10. the single-tower baselines in bf16 at the published width: SwinUNet at
   the JAX bench's seg_only_b64_bf16 ([64, 2, 250, 480] uniform(0, 1e3),
   make_segmentation_fn) and SwinUNetSR ([4, 1, 250, 480] masked
   synthesized patterns, make_sr_fn, out [4, 1, 500, 960]), 3 requests
   each, replays of the two programs: one graph each, launches per replay
   against the gate (6 and 10 cst), the replay against the same call run
   eagerly (the same bits, else PIPE_TOL), the output
   against the same weights with fused_blocks=False (PIPE_TOL; SwinUNetSR's
   against the kernel's plain versions and beside the unfused route against
   the fp32 model), ms a call, images/s, peak memory;
   one fp32 SwinUNet call at B=64 (2 cst); cst at the B=64 shapes is held
   against plain in [2];
11. the split route: SwinWNetInference(split=True) on the bf16 serving
   configuration, 3 requests: the 8 stage tensors against split=False,
   launches per call, ms a call of both routes;
12. the eval harness: MetricsCalculator over 2 batches of [4, 2, 250, 480]
   patterns and masks from synthesize_dataset on the published SwinWNet:
   the three Calculate* methods in fp32 on the kernel route against the
   plain route sample by sample (segmentation 1e-4, PSNR 1e-3 dB, SSIM
   1e-5, physics 1e-3 relative, with the peak tables of any sample outside
   it), launches against the gate; then in bf16 with the notebook
   convention and an AlphaPolicy: schema, finite values, ms a sample of
   each method, the results JSON written and read back;
13. the viewer CLI, the user's entry point, at the published width in fp32
   on 6 synthesize_dataset patterns (the held-out set's size) from an
   upstream-format .pth ({"state_dict": {"module." + k: v}}) and a raw and
   a dict .npy: `python -m swinwnet_tpu_torch.apps.viewer` as a subprocess
   (exit 0, 8 stage .npy and 2 CSVs), then `viewer.main(argv)` in-process
   three times: launches per call against the gate (10 cst), the 8 stages
   against the same weights at fused_blocks=False (PIPE_TOL), both CSVs
   against a float64 bincount of the saved stages (1e-5), error_matrix
   sniffed; then ViewerModel's load_weights -> load_npy -> run_inference ->
   export_csv, the CLI's stages bit for bit;
14. the C++ NativeBatcher, built with g++, feeding SegmentatorTrainer one
   epoch of 24 synthesize_dataset patterns in batches of 8 with the train
   noise, fp32, fused_blocks and fused_deep: launches per step against the
   gate ([2, 14, 0]), finite losses; two batchers with one seed give the
   same batches; the eval-noise protocol gives N(100, 20);
15. the renderer's calibration: detect_table, extract_crystal_spec and
   refine_crystal_spec(iters=2) on a render_calibrated pattern with the
   rebin on the card and on the CPU give the same peaks (d within one bin);
16. times: per call, per training and RL step, and per kernel and on-path shape the kernel, its
   plain version and its bound; for cst and wide the plan, the body it
   takes, its registers and CTAs an SM; for the row-major kernel also the
   same launch with [in, out]-stored weights and the plan of its CTAs; the
   rebin (segment sums, and index_add_ beside it) and the metrics alone;
   the baselines', split and harness rows of [10]-[12]; the viewer's ms a
   call and images/s, the batcher's ms a batch against ArrayLoader and the
   steps it fed, the calibration's ms on each device.
17. the model's remaining features at the published width: one stage-3
   odd step in fp32 at [8, 2, 250, 480] without fused_deep (the JAX
   default: the C = 96-384 levels unfused) twice without remat, which must
   give the same bits in the loss and every gradient, and once with it,
   from the same weights (loss, gradients, cst launches against the gate,
   peak memory and time of each); drop = attn_drop = drop_path = 0.1: a
   bf16 serving call at deterministic=True equal bit for bit to the
   rates-0 model's with its 22 cst, a deterministic=False stage-3 odd step
   at B=2 with no launch, one seed one loss (and the same bits twice) and
   two seeds two, remat's gradients against the plain step's and a control
   with other masks, the keep fraction of an [8, 2, 250, 480] draw; a
   shifted BasicLayer on cuda against the CPU at encoder L0's grid and at
   one that does not tile; attn_chunk=64 against unchunked on an unfused
   level; one fp32 step of each stage under
   torch.use_deterministic_algorithms(True, warn_only=True), with the ops
   that warn; the segmentation heads' bilinear resizes at B=4 and 64
   against F.interpolate, both timed forward and backward, two backward
   passes the same bits;
18. data parallelism: dryrun_multichip over NCCL on every card, two steps
   of make_stage3_steps' odd step with the gradients' mean in it (the
   second a replay of the captured step, all-reduce included) against the
   same two steps in one process run eagerly (the same bits, else
   REMAT_GRAD_TOL); then two gloo ranks on one card at [2, 2, 250, 480]
   against one process on the full batch (loss, gradients, updated
   parameters, HR IoU), run eagerly: gloo copies CUDA tensors through the
   host, which no graph can capture.
19. the user's recipes (swinwnet_tpu_torch/recipes), each through its
   `main(argv)` as `python -m` runs it: quality_run at the published width
   and full geometry with the flagship flags (bf16, SmoothL1SSIMLoss,
   keep-best, flip-augment, remat, attn_chunk=8192, --fused-blocks) on 8
   training and 6 held-out renders, one epoch a stage: ms, launches
   against the gate and peak memory of every bf16 step at B=4, every fp32
   eval serving call at 10 cst, finite losses, the files and their keys
   against the JAX script's and the committed QUALITY_r05 files, seconds by
   part; the first bf16 step of each stage (on the batch the recipe took)
   through the kernels against their plain versions and against fp32,
   frozen parameters the same bits; quality_continue and rl_run from the
   checkpoint (26 cst an RL step), classical_baselines with the ground
   truth's and the checkpoint's masks, and train_synthetic;
20. entry() (swinwnet_tpu_torch/entry.py) on the card: fn(model, x) of
   shape [1, 2, 500, 960], finite, and the same weights through the fused
   kernels' route (10 cst) against it at PIPE_TOL fp32;
21. (no phase: the port's speed is measured by benchmark/run.py, not here)
22. the compiled programs (core/graphs.py: a CUDA graph captured once per
   input shape and replayed) at the published width and full geometry:
   make_inference_fn in bf16 (B=4 and B=1), in fp32 and on the nmajor
   route, make_split_inference_fn and make_rl_inference_fn against the same
   pipelines run eagerly on the same weights (the same bits, else
   PIPE_TOL), launches a replay against the gate, an earlier call's
   tensors intact after the next, a new batch size and a replaced Parameter
   capturing again, load_state_dict not; the split programs against the
   single one bit for bit; make_inference_fn in bf16 and
   make_rl_inference_fn at B=64 and an fp32 model with every level unfused
   at B=8, each captured and replayed against eager with its launches
   against the gate (none unfused); make_inference_fn on the data mesh over
   every card (NCCL, a rank a card): the bf16 model replicated from rank 0
   (parallel.replicate) and each rank's 64 images of the global batch
   (parallel.shard_batch), the weights against rank 0's, the replay against
   eager and its launches against the gate; the RL step (make_rl_train_step) in bf16 at
   [4, 2, 250, 480] on rl_model and Bragg lines: four captured steps
   against four eager rl_steps from the same weights and noise (every
   metric, model and policy leaf the same bits, else [8]'s limits; frozen
   leaves; 26 cst a step, 8 of them the narrow body), the gate alone
   captured against its warm-up, a capture on a batch with few
   distance-gate candidates replayed on one with more against eager on
   both, and the control with the gate's bound frozen at the first batch's
   count, which must fail; then four captured training steps of each stage
   (fp32 B=8 with fused_deep, bf16 B=4 with remat) against four eager ones
   from the same weights and batches, the learning rate doubling between
   steps 2 and 3: losses and every leaf (the same bits, else [4]'s
   limits), frozen leaves, launches a step; and a control at epoch 0's rate
   throughout that must fail after step 3.

The serving and training phases ([3], [4], [5], [7], [10]-[14],
[17], [18], [19]) run through the programs because their callers
do; a route that swaps functions in at run time (the plain versions, the
pad-mask control, [8]'s timers) runs under
`core.graphs.run_eagerly()`, and so does a gloo group on the card. Every
plain route (the blocks' plain versions, the unfused levels, a model built
with fused_blocks=False) runs the expansions' and the window attention's
plain versions too (plain_levels): serving runs under
`torch.inference_mode`, where `PatchExpanding` and `WindowAttention` take
their kernels whatever the blocks' route.

In bf16 each pipeline stage's mean error against the plain route is held to
a limit from its own scale (bf16_limits): the smaller of how far bf16 moves
it from fp32 (times 1.25) and its sources' limits carried through its own
fp32 maps, and for a stage made from the sources no more than PIPE_TOL's
mean; SwinUNetSR's output is held so at its source, before expm1.

Exits non-zero on any failure. The last lines are one JSON line on the
kernels, the card's name and power limit (nvidia-smi), and
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import ast
import contextlib
import cProfile
import importlib.util
import io
import json
import os
import pstats
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np
import torch

import torch.nn.functional as F

from swinwnet_tpu_torch.apps import viewer
from swinwnet_tpu_torch.apps.viewer import ViewerSession
from swinwnet_tpu_torch.apps.viewer_state import ViewerModel
from swinwnet_tpu_torch.compat import load_pth
from swinwnet_tpu_torch.core import graphs, resolve_dtype
from swinwnet_tpu_torch.data import (
    ArrayLoader,
    NativeBatcher,
    detect_table,
    extract_crystal_spec,
    make_train_noise_augment,
    refine_crystal_spec,
    render_calibrated,
    synthesize_dataset,
    synthesize_pattern,
)
from swinwnet_tpu_torch.data import native_loader
from swinwnet_tpu_torch.evalharness import MetricsCalculator, write_results_json
from swinwnet_tpu_torch.models import (
    AlphaPolicy,
    BasicLayer,
    ScaleAwarePatchEmbed,
    SegmentationHead,
    SwinUNet,
    SwinUNetSR,
    SwinWNet,
    apply_action,
    init_weights,
)
from swinwnet_tpu_torch.models import layers as layers_mod
from swinwnet_tpu_torch.ops import expand_norm as en
from swinwnet_tpu_torch.ops import swin_block as sb
from swinwnet_tpu_torch.ops import window_attention as wa
from swinwnet_tpu_torch.ops.norms import denormalize_piecewise, ensure_2ch, normalize_piecewise
from swinwnet_tpu_torch.ops.resize import bilinear_resize
from swinwnet_tpu_torch.parallel import dryrun as dryrun_mod
from swinwnet_tpu_torch.parallel import dryrun_multichip
from swinwnet_tpu_torch.parallel.dryrun import dryrun_batch
from swinwnet_tpu_torch.ops.window import window_pad_mask_np
from swinwnet_tpu_torch.physics import Qwrapper, d_centers_hr, d_centers_lr, find_peaks_for_batch, peak_matching_loss
from swinwnet_tpu_torch.physics import peaks as peaks_mod
from swinwnet_tpu_torch.physics.device_metrics import diffraction_metrics_device
from swinwnet_tpu_torch.pipelines import (
    STAGE_NAMES,
    RLInference,
    SwinWNetInference,
    make_inference_fn,
    make_rl_inference_fn,
    make_segmentation_fn,
    make_split_inference_fn,
    make_sr_fn,
    rl_inference_stages,
)
from swinwnet_tpu_torch.train import (
    AdamW,
    FullModelTrainer,
    RLState,
    RLTrainer,
    SegmentatorTrainer,
    SwinWNetTrainingPipeline,
    TrainState,
    UpscalerTrainer,
    combined_loss,
    make_stage1_step,
    make_stage2_step,
    make_rl_train_step,
    make_stage3_steps,
    masked_adamw,
    rl_step,
    smooth_l1_loss,
    smooth_l1_ssim_loss,
    warmup_cosine_schedule,
)
from swinwnet_tpu_torch.train import rl as rl_mod
from swinwnet_tpu_torch.train.trainers import compute_dtype_of, stage3_odd_loss

REPO_ROOT = os.path.dirname(os.path.abspath(__file__))
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
# bf16 routes, kernel against plain, stage by stage: the max as PIPE_TOL's,
# the mean from the stage's own scale (bf16_limits), the smaller of two
# measures of it. (1) How far bf16 rounding itself moves the stage: the plain
# route's mean distance from the same model computed in fp32, times
# BF16_NOISE_FACTOR; the kernel rounds at the plain route's points in other
# orders, so it should sit no farther from it. (2) Its sources' limits
# carried through its own fp32 maps (the mask products, normalize, the RL
# gain, expm1 and the range scaling; carried_limits): the seg maps, held to
# PIPE_TOL's bf16 mean (1e-3) as before, and the bf16 SR output s before
# expm1, moved by BF16_MEAN_STEPS bf16 steps at its RMS (2^-8 * rms(s)
# each). A masked stage thus gets a small limit where its mask is small, a
# stage after expm1 and the range scaling gets it in its own units. The
# stages made from the sources (the masked images, norm, upscaled_denorm)
# never exceed PIPE_TOL's mean of their scale, their limit before, either.
# Neither measure alone would do: SwinUNetSR's tower, with no fp32
# cross-attention trunk, rounds more than SwinWNet's, and sits farther from
# its plain route in steps of its output than the control that drops every
# cst pad mask sits at RL's upscaled_norm, which the mean check must refuse
# on its own. The report of each stage prints the measures.
BF16_NOISE_FACTOR = 1.25
BF16_MEAN_STEPS = 2.25
# the pipeline's stages that are not made from others by fp32 maps: the
# input, the seg maps (probabilities) and the SR output before expm1
BF16_SOURCES = ("images", "seg_map_lr", "seg_map_hr", "upscaled_norm")
# (name, C, nH, token grid at B=1, launches per pipeline call in bf16)
LEVELS = [
    ("encoder L0", 48, 3, (125, 240), 6),
    ("encoder L1", 96, 6, (63, 120), 6),
    ("decoder last", 96, 3, (125, 240), 6),
    ("SR level 1", 24, 3, (250, 480), 2),
    ("SR level 2", 12, 3, (500, 960), 2),
]
LAUNCHES_PER_CALL = {torch.bfloat16: 22, torch.float32: 10}
# PatchExpanding's kernel (patch_expand_norm): 11 launches a SwinWNet serving
# call in either dtype (segment_1's and segment_2's decoders three each, the
# upscaler's decoder three and its SR head two), at these (C/2, token grid
# of its input at B=1): the decoders' three, the SR head's two
EXPANSIONS_PER_CALL = 11
EXPAND_LEVELS = [(192, (16, 30)), (96, (32, 60)), (48, (63, 120)), (24, (125, 240)), (12, (250, 480))]
# the unfused levels' window attention (window_attention): two launches a level
# that the gate leaves unfused in bf16 serving with a head width of 16 or 32,
# 30 a SwinWNet call (encoder L2, L3, the bottleneck and decoder stages 0 and
# 1 of its three towers), at these (C, nH, token grid at B=1)
ATTENTIONS_PER_CALL = 30
ATTEND_LEVELS = [(384, 24, (16, 30)), (192, 12, (32, 60)), (384, 12, (32, 60)), (192, 6, (63, 120))]
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
# the baselines at the published width (core/config.py); SwinUNet at the JAX
# bench.py's seg_only_b64_bf16 record (bench.py:248-262): batch 64, bf16
PUBLISHED = dict(patch_size=2, embed_dim=48, depths=(2, 2, 2, 2), num_heads=(3, 6, 12, 24), window_size=5)
SEG_B = 64
# SwinUNet's cst launches at SEG_B: (name, C, nH, token grid, launches a bf16
# call); the masked encoder L1 has 19968 windows
SEG_LEVELS = [
    ("B64 encoder L0", 48, 3, (125, 240), 2),
    ("B64 encoder L1", 96, 6, (63, 120), 2),
    ("B64 decoder last", 96, 3, (125, 240), 2),
]
# the fp32 patch embedding and segmentation head against float64, of their
# max: full fp32 sums of up to 432 products are good to ~1e-6; TF32 operands
# (a 10-bit mantissa) are off by ~1e-4 and fail it
FP32_TOL = 1e-5
# the eval harness, kernel route against plain route in fp32, per sample: the
# segmentation scores (a pixel at a threshold may flip), PSNR in dB, SSIM,
# and the physical metrics relative
HARNESS_TOL = {"seg": 1e-4, "psnr": 1e-3, "ssim": 1e-5, "phys": 1e-3}
HARNESS_N = 8  # two batches of B
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
# the viewer CLI: the published held-out set's size, fp32 (the JAX viewer's
# precision), timed calls; its I(d) CSVs against a float64 bincount of the
# saved stages, each column within 1e-5 of its max (fp32 sums of up to a few
# hundred pixels a bin, written with Python's float repr)
VIEW_B, VIEW_CALLS, CSV_RTOL = 6, 3, 1e-5
# the batcher-fed stage-1 epoch: 24 patterns, batches of TRAIN_B (3 steps);
# batches timed from NativeBatcher.next() and from ArrayLoader
BATCHER_N, BATCHER_TIMED = 24, 9
# remat against none (fp32 on the card): the recompute repeats the
# forward's arithmetic, so the loss to 1e-6 relative and each gradient to
# 1e-5 of its leaf's max. The backward is deterministic (the bilinear resize
# is two products by fixed interpolation matrices, ops/resize.py, where
# F.interpolate's CUDA backward summed with atomic adds in any order), so
# two runs of the plain step must give the same bits, and neither check
# makes room for run-to-run noise. With dropout, remat's gradients are held
# to REMAT_GRAD_TOL too, against a control with other masks that must
# exceed it
REMAT_LOSS_RTOL, REMAT_GRAD_TOL = 1e-6, 1e-5
DROP_RATES = dict(drop=0.1, attn_drop=0.1, drop_path=0.1)
# the dropout step runs every level unfused, the SR head's 500x960-token
# levels too: a smaller batch keeps its activations well inside the card
DROP_B = 2
# a shifted level on cuda against cpu, and attn_chunk against none: fp32
# sums in other orders, 1e-5 of max
SHIFT_TOL = 1e-5
ADAM_EPS = 1e-8  # train.freeze.AdamW's


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
def plain_levels():
    """Route the levels' serving kernels, PatchExpanding's and the unfused
    levels' window attention, to their plain versions on the card, for
    comparison; the programs run eagerly meanwhile, since a graph keeps the
    kernels it captured."""
    orig = layers_mod.patch_expand_norm, layers_mod.window_attention
    layers_mod.patch_expand_norm = en.patch_expand_norm_plain
    layers_mod.window_attention = wa.window_attention_plain
    try:
        with graphs.run_eagerly():
            yield
    finally:
        layers_mod.patch_expand_norm, layers_mod.window_attention = orig


@contextlib.contextmanager
def plain_blocks():
    """Route the differentiable block's three entries and the levels'
    serving kernels (plain_levels) to their plain versions on the card, for
    comparison; the programs (core.graphs) run eagerly meanwhile, since a
    graph keeps the entries it captured."""
    orig = (sb.fused_swin_block_cst, sb.fused_swin_block, sb.fused_swin_block_wide)
    sb.fused_swin_block_cst = sb.swin_block_plain
    sb.fused_swin_block = sb.swin_block_rowmajor_plain
    sb.fused_swin_block_wide = sb.swin_block_wide_plain
    try:
        with plain_levels():
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


def tower_levels(image_hw, with_sr_head):
    """(C, nH, token grid) of each level of one tower pass (encoder,
    bottleneck, decoder, and the SR head when the tower is the upscaler)
    over a [h, w] image at patch size 2 (or a [2h, 2w] one at scale 2)."""
    g0 = half(image_hw)
    g1 = half(g0)
    g2 = half(g1)
    g3 = half(g2)
    levels = [(48, 3, g0), (96, 6, g1), (192, 12, g2), (384, 24, g3), (384, 24, g3), (384, 12, g2), (192, 6, g1),
              (96, 3, g0)]
    if with_sr_head:
        levels += [(24, 3, (2 * g0[0], 2 * g0[1])), (12, 3, (4 * g0[0], 4 * g0[1]))]
    return levels


def tower_launches(image_hw, batch, dtype, fused_deep, layout, with_sr_head):
    """Launches per kernel of one tower pass: two blocks a level."""
    out = [0, 0, 0]
    for C, _, grid in tower_levels(image_hw, with_sr_head):
        k = gate_route(C, grid, batch, dtype, fused_deep, layout)
        if k is not None:
            out[k] += 2
    return out


def tower_attentions(image_hw, batch, dtype, layout, with_sr_head):
    """`window_attention` launches of one serving tower pass: two a level
    that the gate leaves unfused, in bf16, at a head width of 16 or 32."""
    if dtype != torch.bfloat16:
        return 0
    return sum(2 for C, nH, grid in tower_levels(image_hw, with_sr_head)
               if gate_route(C, grid, batch, dtype, False, layout) is None and C // nH in (16, 32))


def serve_attentions(batch, dtype, layout="cmajor"):
    """`window_attention` launches of one SwinWNet serving call: segment_1,
    the upscaler with its SR head, segment_2."""
    tower = lambda head: tower_attentions((H, W), batch, dtype, layout, head)
    return tower(False) + tower(True) + tower(False)


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


def bf16_ulp(v):
    """One bf16 ulp at each value, 2^(e - 8) for |v| in [2^(e-1), 2^e),
    taken at no less than 2^-8 in magnitude: below it the affine step's
    cancellation (w x + b near 0) leaves a value whose fp32 rounding is
    itself more than one of its bf16 ulps."""
    _, e = torch.frexp(v.float().abs().clamp_min(2.0 ** -8))
    return torch.ldexp(torch.ones_like(v, dtype=torch.float32), e - 8)


def check_expand_norm():
    """`patch_expand_norm` against `patch_expand_norm_plain` at the serving
    pipeline's five expansion shapes, B=1 and B=64, bf16: the two differ
    only in the order of the fp32 sums, so each output within one bf16 ulp
    of the plain value. Returns the worst distance in ulps."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    worst = 0.0
    for c, grid in EXPAND_LEVELS:
        ln = torch.nn.LayerNorm(c).cuda()
        with torch.no_grad():
            ln.weight.copy_(torch.rand(c, generator=gen, device="cuda") + 0.5)
            ln.bias.copy_(torch.randn(c, generator=gen, device="cuda") * 0.1)
        for batch in (1, SEG_B):
            y = (torch.randn(batch, *grid, 4 * c, generator=gen, device="cuda") * 2 + 0.5).to(torch.bfloat16)
            before = en.patch_expand_norm.launches
            out = en.patch_expand_norm(y, ln, torch.bfloat16)
            want = en.patch_expand_norm_plain(y, ln, torch.bfloat16)
            ulps = ((out.float() - want.float()).abs() / bf16_ulp(want)).max().item()
            ok = ulps <= 1 and en.patch_expand_norm.launches == before + 1 and out.shape == want.shape
            print(f"  patch_expand_norm C/2={c:3d} B={batch:2d} y {tuple(y.shape)}: max {ulps:.2f} bf16 ulp of plain "
                  f"(limit 1) {'ok' if ok else 'FAIL'}")
            if not ok:
                raise SystemExit(f"patch_expand_norm disagrees with its plain version at C/2={c}, B={batch}")
            worst = max(worst, ulps)
            del y, out, want
    return worst


def attention_bound(out, qkv, bias, nH):
    """`window_attention`'s distance from `window_attention_plain` over
    its bound, at worst (at most 1), and the share of outputs equal to the
    plain ones. The two sum in other orders, so a probability's fp32 value
    may fall on the other side of its bf16 rounding: one bf16 ulp of P_j,
    at most 2^-7 P_j. So the outputs differ by at most 2^-7 sum_j P_j |v_j|
    before their own rounding to bf16, and by one bf16 ulp of the larger
    value after it."""
    want = wa.window_attention_plain(qkv, bias, nH, torch.bfloat16).float()
    Bw, n, C3 = qkv.shape
    C, hd = C3 // 3, C3 // 3 // nH
    parts = qkv.reshape(Bw, n, 3, nH, hd).permute(2, 0, 3, 1, 4)
    q = parts[0] * torch.tensor(hd ** -0.5, dtype=torch.bfloat16)
    p = torch.softmax(q.float() @ parts[1].float().transpose(-1, -2) + bias, dim=-1).to(torch.bfloat16).float()
    spread = (p @ parts[2].float().abs()).transpose(1, 2).reshape(Bw, n, C) * 2.0 ** -7
    _, e = torch.frexp((want.abs() + spread).clamp_min(2.0 ** -126))
    bound = spread + torch.ldexp(torch.ones_like(want), e - 8)
    return ((out.float() - want).abs() / bound).max().item(), (out.float() == want).float().mean().item()


def check_window_attention():
    """`window_attention` against `window_attention_plain` at the serving
    pipeline's four shapes of the unfused levels, B=1 and B=64, bf16,
    within attention_bound; one launch counted a call. Returns the worst
    distance over the bound."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    worst = 0.0
    for C, nH, grid in ATTEND_LEVELS:
        for batch in (1, SEG_B):
            Bw = n_windows(grid, batch)
            qkv = (torch.randn(Bw, 25, 3 * C, generator=gen, device="cuda") * 1.5).to(torch.bfloat16)
            bias = torch.randn(nH, 25, 25, generator=gen, device="cuda")
            before = wa.window_attention.launches
            out = wa.window_attention(qkv, bias, nH, torch.bfloat16)
            ratio, same = attention_bound(out, qkv, bias, nH)
            ok = ratio <= 1 and wa.window_attention.launches == before + 1 and out.shape == (Bw, 25, C)
            print(f"  window_attention C={C:3d} nH={nH:2d} B={batch:2d} ({Bw} windows): {ratio:.2f} of the rounding "
                  f"bound at worst, {same:.6f} of the outputs the plain ones {'ok' if ok else 'FAIL'}")
            if not ok:
                raise SystemExit(f"window_attention disagrees with its plain version at C={C}, nH={nH}, B={batch}")
            worst = max(worst, ratio)
            del qkv, out
    return worst


def check_kernel(dtype, gen):
    """`fused_swin_block_cst` against plain at the five serving shapes (B=1),
    the five shapes of the RL step's half-size upscale (B=RL_B, padded),
    SwinUNet's at B=SEG_B that the gate sends to it in `dtype`, and a window
    count no CTA size divides; returns the largest absolute error."""
    worst = 0.0
    shapes = [(name, C, nH, grid, 1) for name, C, nH, grid, _ in LEVELS]
    shapes += [(name, C, nH, grid, RL_B) for name, C, nH, grid, _ in RL_LEVELS]
    shapes += [(name, C, nH, grid, SEG_B) for name, C, nH, grid, _ in SEG_LEVELS
               if C <= (96 if dtype == torch.bfloat16 else 48)]
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


def second_stage_windows(plan):
    """A window count whose last, ragged batch is the second its CTA (the
    Hopper body) or warp (the narrow body) takes: the persistent grid is as
    many CTAs as fit the card at once."""
    ctas = plan.min_ctas * torch.cuda.get_device_properties(0).multi_processor_count
    walkers = ctas * (plan.threads // 32 if plan.body == 2 else 1)
    return plan.WB * (walkers + 5) + max(1, plan.WB // 2)


def check_tensor_cores(gen):
    """The bf16 tensor-core bodies (cst and wide: the narrow body at C <= 24,
    the Hopper body above, up to 96) at every on-path
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
        if plan.body != (2 if C <= sb.NARROW_MAX_C else 1):
            raise SystemExit(f"{entry} at C={C} nH={nH} does not take its tensor-core body: {plan}")
        xt, args, mask = level_args(C, nH, grid, 1, bf16, gen)
        # one window fewer, as many and one more than a batch; and a count whose
        # last batch is ragged and the second of its CTA (stage 1 of the pipeline)
        ragged = sorted({plan.WB - 1, plan.WB, plan.WB + 1} - {0}) + [second_stage_windows(plan)]
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


SASS_OPS = ("HMMA", "HGMMA", "UTMALDG", "UBLKCP")


def sass_ops(lib):
    """Tensor-core (HMMA: mma.sync, HGMMA: wgmma) and TMA or bulk-copy load
    (UTMALDG, UBLKCP) instructions per kernel instance in the built
    library's SASS (cuobjdump), as {mangled name: {op: count}}."""
    from torch.utils.cpp_extension import CUDA_HOME

    res = subprocess.run([f"{CUDA_HOME}/bin/cuobjdump", "-sass", str(lib)], capture_output=True, text=True, check=True)
    counts = {}
    for part in res.stdout.split("Function : ")[1:]:
        name = part.split(None, 1)[0]
        got = counts.setdefault(name, dict.fromkeys(SASS_OPS, 0))
        for line in part.splitlines():
            words = line.replace(";", " ").split()
            for op in SASS_OPS:
                got[op] += any(w == op or w.startswith(op + ".") for w in words)
    return counts


def check_sass(lib):
    """The bf16 tensor-core instances of the Hopper body have wgmma (HGMMA)
    and a TMA or bulk-copy load (UTMALDG or UBLKCP), those of the narrow body
    mma.sync (HMMA) and no wgmma; the fp32-FMA body's instances have no
    tensor-core or TMA instruction."""
    counts = sass_ops(lib)
    narrow = {k: v for k, v in counts.items() if "swin_block_hopper_kernel_narrow" in k}
    hopper = {k: v for k, v in counts.items() if "swin_block_hopper_kernel" in k and k not in narrow}
    fma = {k: v for k, v in counts.items() if "swin_block_kernel" in k}
    print(f"  SASS: Hopper body instances {[tuple(v[op] for op in SASS_OPS) for v in hopper.values()]} "
          f"({', '.join(SASS_OPS)}); narrow body instances {sorted(tuple(v[op] for op in SASS_OPS) for v in narrow.values())} "
          f"({len(narrow)} instances); fp32-FMA body instances "
          f"{sorted(tuple(v[op] for op in SASS_OPS) for v in fma.values())} ({len(fma)} instances)")
    if not hopper or any(v["HGMMA"] == 0 or v["UTMALDG"] + v["UBLKCP"] == 0 for v in hopper.values()):
        raise SystemExit("a Hopper body instance has no HGMMA or no TMA / bulk-copy load")
    if len(narrow) != len(sb.NARROW_SHAPES) or any(v["HMMA"] == 0 or v["HGMMA"] for v in narrow.values()):
        raise SystemExit("a narrow body instance is missing, has no HMMA or has HGMMA")
    if not fma or any(sum(v.values()) for v in fma.values()):
        raise SystemExit("an fp32-FMA body instance has tensor-core or TMA instructions")


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


def serve(dtype, batch, n_calls, rng, **model_kw):
    """Drive the pipeline; returns (first request's stages, per-call ms,
    launches per kernel per call, (plain stages, the plain route's stages in
    fp32), plain ms)."""
    model = build_model(dtype, **model_kw)
    infer = SwinWNetInference(model)
    requests = [rng.uniform(0, 1e3, (batch, 2, H, W)).astype(np.float32) for _ in range(n_calls)]
    infer(requests[0])  # warm-up: cuDNN and allocator
    torch.cuda.synchronize()

    sb.reset_counts()
    en.patch_expand_norm.launches = wa.window_attention.launches = 0
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
    expansions = en.patch_expand_norm.launches
    print(f"  patch_expand_norm launches over the {n_calls} calls: {expansions} "
          f"({EXPANSIONS_PER_CALL} a call expected)")
    if expansions != EXPANSIONS_PER_CALL * n_calls:
        raise SystemExit(f"serving launched patch_expand_norm {expansions} times in {n_calls} calls")
    attentions, want = wa.window_attention.launches, serve_attentions(batch, dtype, model_kw.get("fused_layout", "cmajor"))
    print(f"  window_attention launches over the {n_calls} calls: {attentions} ({want} a call from the gate)")
    if attentions != want * n_calls:
        raise SystemExit(f"serving launched window_attention {attentions} times in {n_calls} calls")

    with plain_blocks():
        infer(requests[0])
        torch.cuda.synchronize()
        plain = {k: getattr(infer, k).clone() for k in STAGE_NAMES}
        t0 = time.perf_counter()
        infer(requests[0])
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        with compute_dtype_of(model, torch.float32):  # the bf16 rule's reference
            infer(requests[0])
            ref = {k: getattr(infer, k).clone() for k in STAGE_NAMES}
    if launches() != total or en.patch_expand_norm.launches != expansions or wa.window_attention.launches != attentions:
        raise SystemExit("the plain pipeline launched a kernel")
    del model, infer
    return first, call_ms, per_call, total, (plain, ref), plain_ms


def bf16_step(t):
    """One bf16 step at t's RMS: 2^-8 * rms(t), in float64."""
    return 2.0 ** -8 * t.double().pow(2).mean().sqrt()


def jitter(t, size, seed):
    """t moved by `size` per element, up or down at random (a generator
    seeded `seed`): a rounding difference has no sign, and a move of one
    sign everywhere would cancel in the min-max normalization."""
    sign = torch.randint(0, 2, t.shape, generator=torch.Generator().manual_seed(seed)) * 2 - 1
    return t + size * sign.to(t.device, t.dtype)


def pipeline_maps(images, seg_lr, s, gain, seg_hr, params):
    """The serving pipeline's fp32 maps, in float64, from its sources: the
    LR and HR seg maps and the SR output s (times `gain`, RL's
    sigmoid(alpha)); `params` are the plain route's normalization."""
    masked_lr = images * seg_lr
    up = s * gain
    denorm = denormalize_piecewise(up, params)
    return {"images": images, "seg_map_lr": seg_lr, "images_masked_lr": masked_lr,
            "norm": normalize_piecewise(masked_lr)[0], "upscaled_norm": up, "upscaled_denorm": denorm,
            "seg_map_hr": seg_hr, "images_masked_hr": denorm * seg_hr}


def carried_limits(plain, gain=None):
    """Each stage's bf16 mean limit: the mean change of the stage when its
    sources, recovered from the plain route's stages, move by their limits
    (the seg maps by PIPE_TOL's bf16 mean, the SR output by BF16_MEAN_STEPS
    steps at its RMS, each element up or down), carried through the
    pipeline's maps."""
    st = {k: plain[k].double() for k in STAGE_NAMES}
    g = torch.ones((), dtype=torch.float64, device=st["images"].device) if gain is None else \
        gain.double().reshape(-1, 1, 1, 1)
    s, dp = st["upscaled_norm"] / g, PIPE_TOL[torch.bfloat16][1]
    params = normalize_piecewise(st["images_masked_lr"])[1]
    base = pipeline_maps(st["images"], st["seg_map_lr"], s, g, st["seg_map_hr"], params)
    moved = pipeline_maps(st["images"], jitter(st["seg_map_lr"], dp, 0), jitter(s, BF16_MEAN_STEPS * bf16_step(s), 1),
                          g, jitter(st["seg_map_hr"], dp, 2), params)
    return {k: (moved[k] - base[k]).abs().mean().item() for k in STAGE_NAMES}


def noise_limit(plain, ref):
    """BF16_NOISE_FACTOR times the plain bf16 route's mean distance from the
    fp32 `ref`."""
    return BF16_NOISE_FACTOR * (plain.double() - ref.double()).abs().mean().item()


def bf16_limits(plain, ref, gain=None):
    """Each pipeline stage's bf16 mean limit: the smaller of its noise limit
    and its carried limit, and for a stage made from the sources, no more
    than PIPE_TOL's bf16 mean of its max. Returns (limits, the three
    measures by stage, as text for the report)."""
    carried = carried_limits(plain, gain)
    limits, parts = {}, {}
    for k in carried:
        noise = noise_limit(plain[k], ref[k])
        limits[k] = min(carried[k], noise)
        parts[k] = f"noise {noise:.3e}, carried {carried[k]:.3e}"
        if k not in BF16_SOURCES:
            ceiling = PIPE_TOL[torch.bfloat16][1] * plain[k].abs().max().item()
            limits[k] = min(limits[k], ceiling)
            parts[k] += f", PIPE_TOL {ceiling:.3e}"
    return limits, parts


def sr_source(out, request):
    """make_sr_fn's output taken back through the request's normalization
    (the inverse of expm1 and the range scaling): the model's output s."""
    params = normalize_piecewise(torch.as_tensor(request, device=out.device).double())[1]
    lo, hi, thr = params["x_min"], params["x_max"], params["threshold"]
    x01 = (out.double() - lo) / (hi - lo + 1e-6)
    return torch.where(x01 > thr, torch.log1p(x01), x01)


def bf16_compare(tag, got, plain, limits, quiet=False):
    """`got` against the plain route, stage by stage (`limits`: stage ->
    its mean limit, or (limit, the measures it is the smallest of)): the
    max within PIPE_TOL's of the stage's scale (1 for probabilities, else
    max|plain|), the mean within its limit. Returns (the stages that fail,
    each stage's mean error over its limit)."""
    if isinstance(limits, tuple):
        limits, parts = limits
    else:
        parts = {}
    tol_max = PIPE_TOL[torch.bfloat16][0]
    failed, ratios = [], {}
    for k, tol_mean in limits.items():
        a, b = got[k].float(), plain[k].float()
        scale = 1.0 if k.startswith("seg") else max(b.abs().max().item(), 1e-30)
        err, mean = (a - b).abs().max().item(), (a - b).abs().mean().item()
        ratios[k] = mean / tol_mean if tol_mean else (float("inf") if mean else 0.0)
        ok = bool(torch.isfinite(a).all()) and err <= tol_max * scale and mean <= tol_mean
        if not quiet:
            measures = f"; the smallest of {parts[k]}" if k in parts else ""
            print(f"  {tag} {k:17s} kernel vs plain: max_abs={err:.3e} (tol {tol_max * scale:.3e}) mean_abs={mean:.3e} "
                  f"(tol {tol_mean:.3e}, {ratios[k]:.2f} of it{measures}) {'ok' if ok else 'FAIL'}")
        if not ok:
            failed.append(k)
    return failed, ratios


def check_pipeline(dtype, batch, stages, plain_ref, per_call, want):
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
    plain, ref = plain_ref
    if dtype == torch.bfloat16:
        failed, _ = bf16_compare("serving", stages, plain, bf16_limits(plain, ref))
        if failed:
            raise SystemExit(f"bf16 pipeline: {failed} disagree with the plain pipeline")
        return
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


def check_frozen(stage, before, after, grads=None):
    """Frozen parameters unchanged bit for bit, trainable ones changed (after
    one step, given its `grads`: those with a gradient)."""
    trains = STAGE_TRAINS[stage]
    n_frozen = n_moved = 0
    for k in before:
        same = torch.equal(before[k], after[k])
        if trains(k.split(".")[0]):
            if grads is not None and k not in grads:
                continue
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
    del model
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
    rebin = graphs.Program(qw.rebin)
    rebin(x_dev)  # the warm-up, then the capture
    replay = rebin(x_dev)
    ok = rebin.num_graphs == 1 and torch.equal(replay, got)
    print(f"  the rebin as a program (segment_reduce without its check, which reads the lengths back): the replay "
          f"equals the eager rebin bit for bit {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("physics: the captured rebin differs from the eager one")

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


def rl_stage_check(got, plain, ref, quiet=False):
    """Every RL-serving stage in `got` against the plain route's under the
    bf16 rule (bf16_limits against the fp32 `ref`; the gain sigmoid(alpha)
    is one of the maps), and alpha, the fp32 policy's output, at PIPE_TOL
    bf16 of its max. Returns (the stages that fail, each stage's mean error
    over its limit)."""
    stages = {k: plain[k] for k in STAGE_NAMES}
    failed, ratios = bf16_compare("RL", got, stages, bf16_limits(stages, ref, torch.sigmoid(plain["alpha"])), quiet)
    a, b = got["alpha"].float(), plain["alpha"].float()
    tol_max, tol_mean = (t * b.abs().max().item() for t in PIPE_TOL[torch.bfloat16])
    err, mean = (a - b).abs().max().item(), (a - b).abs().mean().item()
    ok = bool(torch.isfinite(a).all()) and err <= tol_max and mean <= tol_mean
    if not quiet:
        print(f"  RL alpha             kernel vs plain: max_abs={err:.3e} (tol {tol_max:.3e}) mean_abs={mean:.3e} "
              f"(tol {tol_mean:.3e}) {'ok' if ok else 'FAIL'}")
    if not ok:
        failed.append("alpha")
    return failed, ratios


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
    wa.window_attention.launches = 0
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
    total, attentions = launches(), wa.window_attention.launches
    with plain_blocks():
        infer(requests[0])
        torch.cuda.synchronize()
        plain = {k: getattr(infer, k).clone() for k in names}
        t0 = time.perf_counter()
        infer(requests[0])
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        with compute_dtype_of(infer.model, torch.float32):  # the bf16 rule's reference
            infer(requests[0])
            ref = {k: getattr(infer, k).clone() for k in names}
    want = expected_launches("serve", RL_B, bf16, False, "cmajor")
    want_att = serve_attentions(RL_B, bf16)
    if (launches() != total or any(n != want for n in per_call) or attentions != want_att * n_calls
            or wa.window_attention.launches != attentions):
        raise SystemExit(f"RL serving: launches per call {per_call} (gate: {want}), window_attention {attentions} in "
                         f"{n_calls} calls (gate: {want_att} a call), or the plain route launched")
    failed, _ = rl_stage_check(first, plain, ref)
    if failed:
        raise SystemExit(f"RL serving: {failed} disagree with the plain route or are not finite")
    # a control: the first request again with every cst launch ignoring its
    # pad mask (a fault of the padded levels) must fail that comparison
    call = sb._kernel_call
    sb._kernel_call = lambda layout, nH, x, mask, *w: call(layout, nH, x, None if layout == "cmajor" else mask, *w)
    try:
        with graphs.run_eagerly():  # the graph keeps the masked calls it captured
            infer(requests[0])
        torch.cuda.synchronize()
    finally:
        sb._kernel_call = call
    caught, ratios = rl_stage_check({k: getattr(infer, k) for k in names}, plain, ref, quiet=True)
    ok = ratios["upscaled_norm"] > 1.0
    print(f"  control, every cst launch without its pad mask: fails at {caught}; upscaled_norm's mean error "
          f"{ratios['upscaled_norm']:.2f}x its limit (the mean check alone must refuse it) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("RL serving: the upscaled_norm mean check does not catch a dropped pad mask")
    print(f"  RL serving launches per call [cst, row-major, wide] {per_call} (gate: {want}), window_attention "
          f"{want_att}; alpha "
          f"{[round(v, 4) for v in first['alpha'].flatten().tolist()]}")
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
    CUDA events around the functions it calls, so the step program runs
    eagerly here (`graphs.run_eagerly`: a graph keeps the functions it
    captured); [22] runs it captured. Returns (per-step ms, reward ms,
    distance-gate ms, the gate's candidates a call, launches in the run,
    peak GiB)."""
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
        with graphs.run_eagerly():
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
    print(f"  RL ms per step, eager {[round(ms, 1) for ms, _ in steps]}; of which the reward (2 rebins + metrics) "
          f"{[round(t, 2) for t in reward_ms]}, the distance gate {[round(t, 2) for t in dist]} over "
          f"{peaks_mod.max_candidates(len(d_centers_hr))} ranks ({ranks} of them candidates); peak device memory "
          f"{peak_gb:.2f} GiB")
    return [ms for ms, _ in steps], reward_ms, dist, ranks, total, peak_gb


# ---------------------------------------------------------------------------
# fp32 precision, the single-tower baselines, the split route, the harness
# ---------------------------------------------------------------------------


def fp32_layers_against_float64():
    """The fp32 patch embedding (conv 2->48, stride 2, LayerNorm) and
    segmentation head (conv 3x3 48->24, GELU, conv 1x1 24->1, bilinear x2)
    at the published width on the card, against the same weights in
    float64; returns the two max errors over max|float64|."""
    g = torch.Generator().manual_seed(SEED)
    embed, head = ScaleAwarePatchEmbed(2, 2, 48, torch.float32), SegmentationHead(48, 2, torch.float32)
    for m in (embed, head):
        init_weights(m, g)
        m.cuda()
    x = (torch.rand(2, 2, H, W, generator=g) * 1e3).cuda()
    t = torch.randn(2, H // 2, W // 2, 48, generator=g).cuda()
    with torch.no_grad():
        got_e, _ = embed(x)
        got_h = head(t, (H, W))
        w, b = embed.proj.weight.double(), embed.proj.bias.double()
        ref_e = F.layer_norm(F.conv2d(x.double(), w, b, stride=2).permute(0, 2, 3, 1), (48,),
                             embed.norm.weight.double(), embed.norm.bias.double(), 1e-5)
        c1, c2 = head.seg_head[0], head.seg_head[2]
        y = F.gelu(F.conv2d(t.double().permute(0, 3, 1, 2), c1.weight.double(), c1.bias.double(), padding=1))
        ref_h = F.interpolate(F.conv2d(y, c2.weight.double(), c2.bias.double()), scale_factor=2,
                              mode="bilinear", align_corners=False)
    return [((a.double() - r).abs().max() / r.abs().max()).item() for a, r in ((got_e, ref_e), (got_h, ref_h))]


def check_fp32_precision():
    """Under the flags as found (PyTorch's defaults: cuDNN may round fp32
    operands to TF32), and with TF32 switched on for matmuls and
    convolutions, the port's fp32 layers agree with float64 within FP32_TOL;
    the control, the same check with `full_fp32` made a no-op and TF32 on,
    must fail it."""
    mm, dnn = torch.backends.cuda.matmul, torch.backends.cudnn
    found = (mm.allow_tf32, dnn.allow_tf32)
    errs = fp32_layers_against_float64()
    protect = layers_mod.full_fp32
    try:
        mm.allow_tf32 = dnn.allow_tf32 = True
        errs_on = fp32_layers_against_float64()
        layers_mod.full_fp32 = lambda dtype=torch.float32: contextlib.nullcontext()
        control = fp32_layers_against_float64()
    finally:
        layers_mod.full_fp32 = protect
        mm.allow_tf32, dnn.allow_tf32 = found
    ok = max(errs) <= FP32_TOL and max(errs_on) <= FP32_TOL and max(control) > FP32_TOL
    print(f"  fp32 patch embedding, segmentation head against float64 (tol {FP32_TOL:.0e} of max): under the flags "
          f"as found (matmul.allow_tf32={found[0]}, cudnn.allow_tf32={found[1]}) {errs[0]:.2e}, {errs[1]:.2e}; "
          f"with TF32 on {errs_on[0]:.2e}, {errs_on[1]:.2e}; control, full_fp32 off and TF32 on: {control[0]:.2e}, "
          f"{control[1]:.2e} (must fail) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("fp32: a layer is not at full fp32, or the control does not fail")
    return errs, control


@contextlib.contextmanager
def unfused(model):
    """The model's levels on the unfused blocks, as a model built with
    fused_blocks=False (the same weights): the plain route of the
    baselines and the harness."""
    levels = [m for m in model.modules() if isinstance(m, BasicLayer)]
    for m in levels:
        m.fused_blocks = False
    try:
        with plain_levels():
            yield
    finally:
        for m in levels:
            m.fused_blocks = True


def pipe_compare(tag, got, plain, dtype, relative):
    """`got` against the plain route at PIPE_TOL, absolute (probabilities)
    or relative to max|plain|."""
    tol_max, tol_mean = PIPE_TOL[dtype]
    a, b = got.float(), plain.float()
    scale = b.abs().max().item() if relative else 1.0
    err, mean = (a - b).abs().max().item(), (a - b).abs().mean().item()
    ok = bool(torch.isfinite(a).all()) and err <= tol_max * scale and mean <= tol_mean * scale
    print(f"  {tag} kernel vs plain route: max_abs={err:.3e} (tol {tol_max * scale:.3e}) mean_abs={mean:.3e} "
          f"(tol {tol_mean * scale:.3e}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"{tag}: disagrees with the plain route or is not finite")


# SwinUNetSR in bf16: the kernel route may sit no farther from the fp32 model
# (the same weights) than the unfused blocks' bf16 route does, by this factor
SR_FP32_RATIO = 1.25


def sr_against_fp32(model, fn, request, got, unfused_out):
    """SwinUNetSR's bf16 output through make_sr_fn on the kernel route:
    against the kernel's plain versions (the same cast points) under the
    bf16 rule at its source, the model's output s before expm1 and the
    range scaling (sr_source; its mean limit the smaller of its noise limit
    against the fp32 model and BF16_MEAN_STEPS bf16 steps at its RMS), and
    after them at PIPE_TOL's max; and, since the unfused blocks round at
    other points, against the fp32 model beside the fused_blocks=False
    route: no farther from it by more than SR_FP32_RATIO, in max and
    mean."""
    with plain_blocks():
        plain = fn(request)
    with unfused(model), compute_dtype_of(model, torch.float32), graphs.run_eagerly():
        ref = fn(request).float()
    s_got, s_plain, s_ref = (sr_source(t, request) for t in (got, plain, ref))
    steps, noise = BF16_MEAN_STEPS * bf16_step(s_plain).item(), noise_limit(s_plain, s_ref)
    err = (got.float() - plain.float()).abs().max().item()
    tol_max = PIPE_TOL[torch.bfloat16][0] * plain.float().abs().max().item()
    failed, _ = bf16_compare("SwinUNetSR output before expm1 (s), against the kernel's plain versions:",
                             {"s": s_got}, {"s": s_plain},
                             ({"s": min(steps, noise)}, {"s": f"noise {noise:.3e}, carried {steps:.3e}"}))
    print(f"  SwinUNetSR output after expm1, against the kernel's plain versions: max_abs={err:.3e} (tol "
          f"{tol_max:.3e}) {'ok' if err <= tol_max else 'FAIL'}")
    if failed or not err <= tol_max:
        raise SystemExit("SwinUNetSR: disagrees with the kernel's plain versions or is not finite")
    scale = ref.abs().max().item()
    dist = {name: ((a.float() - ref).abs().max().item() / scale, (a.float() - ref).abs().mean().item() / scale)
            for name, a in (("kernel", got), ("fused_blocks=False", unfused_out))}
    d_ku = (got.float() - unfused_out.float()).abs()
    ok = all(dist["kernel"][i] <= SR_FP32_RATIO * dist["fused_blocks=False"][i] for i in (0, 1))
    print(f"  SwinUNetSR output against the fp32 model (same weights), of its max: kernel route max {dist['kernel'][0]:.3e} "
          f"mean {dist['kernel'][1]:.3e}; fused_blocks=False route max {dist['fused_blocks=False'][0]:.3e} mean "
          f"{dist['fused_blocks=False'][1]:.3e}; the two bf16 routes apart max {d_ku.max().item() / scale:.3e} mean "
          f"{d_ku.mean().item() / scale:.3e} (kernel no farther than {SR_FP32_RATIO}x) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("SwinUNetSR: the kernel route is farther from the fp32 model than the unfused bf16 route")


def masked_patterns(rng, batch):
    """[batch, 1, 250, 480] synthesized patterns times their peak masks."""
    images, masks = synthesize_dataset(batch, seed=int(rng.integers(1 << 30)))
    return (images * masks)[:, None].astype(np.float32)


def serve_baseline(kind, rng, n_calls=3):
    """SwinUNet through make_segmentation_fn at [SEG_B, 2, 250, 480]
    uniform(0, 1e3), or SwinUNetSR through make_sr_fn at [B, 1, 250, 480]
    masked patterns, bf16, fused_blocks, both programs: one graph, launches
    per replay against the gate, the first replay against the same call
    run eagerly (the same bits, else PIPE_TOL) and against the plain route.
    Returns (per-call ms, plain ms, launches in the run, peak GiB, images a
    call)."""
    bf16 = torch.bfloat16
    gen = torch.Generator().manual_seed(SEED)
    sr = kind == "SwinUNetSR"
    cls, make_fn, c, batch = (SwinUNetSR, make_sr_fn, 1, B) if sr else (SwinUNet, make_segmentation_fn, 2, SEG_B)
    model = cls(in_chans=c, fused_blocks=True, dtype=bf16, device="cuda", generator=gen, **PUBLISHED)
    fn = make_fn(model)
    if sr:
        requests = [masked_patterns(rng, batch) for _ in range(n_calls)]
    else:
        requests = [rng.uniform(0, 1e3, (batch, c, H, W)).astype(np.float32) for _ in range(n_calls)]
    fn(requests[0])  # the program's warm-up (cuDNN, the allocator) and capture
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    sb.reset_counts()
    wa.window_attention.launches = 0
    per_call, call_ms, first = [], [], None
    for req in requests:
        before = launches()
        t0 = time.perf_counter()
        out = fn(req)
        torch.cuda.synchronize()
        call_ms.append((time.perf_counter() - t0) * 1e3)
        per_call.append([b - a for a, b in zip(before, launches())])
        if first is None:
            first = out
    total, attentions = launches(), wa.window_attention.launches
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    # the calls above replayed the program the warm-up captured: against the
    # same function run eagerly, the same bits
    eager = eagerly(fn)(requests[0])
    bits = torch.equal(first, eager)
    if not bits:
        pipe_compare(f"{kind} replay, against the same call run eagerly", first, eager, bf16, relative=sr)
    eager_n = [b - a for a, b in zip(total, launches())]
    eager_att = wa.window_attention.launches - attentions
    with unfused(model), graphs.run_eagerly():
        t0 = time.perf_counter()
        plain = fn(requests[0])
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
    want = tower_launches((H, W), batch, bf16, False, "cmajor", sr)
    want_att = tower_attentions((H, W), batch, bf16, "cmajor", sr)
    shape = (batch, 1, 2 * H, 2 * W) if sr else (batch, 1, H, W)
    if (launches() != add(total, eager_n) or any(n != want for n in per_call + [eager_n])
            or attentions != want_att * n_calls or eager_att != want_att
            or wa.window_attention.launches != attentions + eager_att or tuple(first.shape) != shape):
        raise SystemExit(f"{kind}: launches per call {per_call}, eagerly {eager_n} (gate: {want}), window_attention "
                         f"{attentions} in {n_calls} calls and {eager_att} eagerly (gate: {want_att} a call), the "
                         f"plain route launched, or the output is {tuple(first.shape)} (want {shape})")
    if fn.program.num_graphs != 1:
        raise SystemExit(f"{kind}: {fn.program.num_graphs} graphs captured for one shape")
    PROGRAM_BITS[f"{kind} bf16"] = bits
    print(f"  {kind} bf16 [{batch}, {c}, {H}, {W}] -> {list(shape)}: launches per replay [cst, row-major, wide] "
          f"{per_call} (gate: {want}), window_attention {want_att}; {fn.program.num_graphs} graph; the replays against the call run eagerly: "
          f"{'the same bits' if bits else 'within PIPE_TOL, not the same bits'}")
    if sr:
        sr_against_fp32(model, fn, requests[0], first, plain)
    else:
        pipe_compare(f"{kind} output, against fused_blocks=False", first, plain, bf16, relative=False)
    print(f"  {kind}: per call {', '.join(f'{t:.1f}' for t in call_ms)} ms (mean {np.mean(call_ms):.1f} ms, "
          f"{batch / np.mean(call_ms) * 1e3:.1f} images/s); plain route {plain_ms:.1f} ms; peak device memory "
          f"{peak_gb:.2f} GiB")
    del model, fn
    return call_ms, plain_ms, total, peak_gb, batch


def seg_fp32_call(rng):
    """One fp32 SwinUNet call through make_segmentation_fn at
    [SEG_B, 2, 250, 480]: launches against the gate (the fp32 cap sends
    only C <= 48 to the kernel), a finite output of probabilities. Returns
    (ms, launches)."""
    model = SwinUNet(in_chans=2, fused_blocks=True, device="cuda", generator=torch.Generator().manual_seed(SEED),
                     **PUBLISHED)
    fn = make_segmentation_fn(model)
    x = rng.uniform(0, 1e3, (SEG_B, 2, H, W)).astype(np.float32)
    fn(x)  # warm-up
    torch.cuda.synchronize()
    sb.reset_counts()
    t0 = time.perf_counter()
    out = fn(x)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    total = launches()
    want = tower_launches((H, W), SEG_B, torch.float32, False, "cmajor", False)
    ok = total == want and bool(((out >= 0) & (out <= 1)).all())
    print(f"  SwinUNet fp32 [{SEG_B}, 2, {H}, {W}]: launches {total} (gate: {want}), probabilities in [0, 1], "
          f"{ms:.1f} ms {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("SwinUNet fp32: launches differ from the gate's, or the output is not probabilities")
    del model, fn
    return ms, total


def split_serve(rng, n_calls=3):
    """SwinWNetInference(split=True) on the bf16 serving configuration: the
    same stage tensors as split=False, launches per call against the gate,
    ms a call of both routes. Returns (split ms, single ms, launches in the
    split run)."""
    bf16 = torch.bfloat16
    model = build_model(bf16)
    single, split = SwinWNetInference(model), SwinWNetInference(model, split=True)
    requests = [rng.uniform(0, 1e3, (B, 2, H, W)).astype(np.float32) for _ in range(n_calls)]
    split(requests[0])  # warm-up: captures the programs' graphs
    single(requests[0])
    torch.cuda.synchronize()
    sb.reset_counts()
    per_call, split_ms = [], []
    for req in requests:
        before = launches()
        t0 = time.perf_counter()
        split(req)
        torch.cuda.synchronize()
        split_ms.append((time.perf_counter() - t0) * 1e3)
        per_call.append([b - a for a, b in zip(before, launches())])
        if req is requests[0]:
            got = {k: getattr(split, k).clone() for k in STAGE_NAMES}
    total = launches()
    single_ms = []
    for req in requests:
        t0 = time.perf_counter()
        single(req)
        torch.cuda.synchronize()
        single_ms.append((time.perf_counter() - t0) * 1e3)
        if req is requests[0]:
            want = {k: getattr(single, k).clone() for k in STAGE_NAMES}
    gate = expected_launches("serve", B, bf16, False, "cmajor")
    if any(n != gate for n in per_call):
        raise SystemExit(f"split: launches per call {per_call} (gate: {gate})")
    same = [k for k in STAGE_NAMES if torch.equal(got[k], want[k])]
    worst = max(((got[k].float() - want[k].float()).abs().max().item(), k) for k in STAGE_NAMES)
    print(f"  split route: launches per call {per_call} (gate: {gate}); stages equal bit for bit to split=False: "
          f"{len(same)}/{len(STAGE_NAMES)}, largest difference {worst[0]:.3e} ({worst[1]})")
    if len(same) < len(STAGE_NAMES):
        with compute_dtype_of(model, torch.float32):
            single(requests[0])
            ref = {k: getattr(single, k).clone() for k in STAGE_NAMES}
        failed, _ = bf16_compare("split", got, want, bf16_limits(want, ref))
        if failed:
            raise SystemExit(f"split: {failed} disagree with split=False")
    print(f"  split route per call {', '.join(f'{t:.1f}' for t in split_ms)} ms (mean {np.mean(split_ms):.1f}); "
          f"split=False {', '.join(f'{t:.1f}' for t in single_ms)} ms (mean {np.mean(single_ms):.1f})")
    del model, single, split
    return split_ms, single_ms, total


HARNESS_METHODS = ("CalculateSegmentationMetrics", "CalculateUpscalerMetrics", "CalculatePhysycalMetrics")


def run_harness(calc):
    """The three methods; returns (results by method, ms by method)."""
    out, ms = {}, {}
    for m in HARNESS_METHODS:
        t0 = time.perf_counter()
        out[m] = getattr(calc, m)()
        torch.cuda.synchronize()
        ms[m] = (time.perf_counter() - t0) * 1e3
    return out, ms


def harness_arrays(res):
    """The harness's per-sample values as named float arrays."""
    seg, sr, phys = (res[m] for m in HARNESS_METHODS)
    arrays = {f"seg {r} {t}": np.array([[d[k] for k in d] for d in rows]) for r in seg for t, rows in seg[r].items()}
    arrays.update({f"{sec} {k}": np.asarray(v) for sec in sr for k, v in sr[sec].items()})
    arrays.update({f"physics {k}": np.asarray(v) for k, v in phys.items()})
    return arrays


def peak_table(calc, loader_images, b):
    """The host peak tables of sample b's SR output (HR grid, scale=True) and
    target (LR grid) on the route in force."""
    down, _, _, up = calc.sr_forward(loader_images)
    pred = find_peaks_for_batch(calc.physical.qw_pred.tensor_to_d(up[b:b + 1, 0:1]), scale=True)[0]
    true = find_peaks_for_batch(calc.physical.qw_true.tensor_to_d(down[b:b + 1, 0:1]), scale=False)[0]
    fmt = lambda table: [(round(r["d"], 4), round(r["integral_intensity"], 3)) for r in table]
    return fmt(pred), fmt(true)


def check_harness(rng):
    """MetricsCalculator over HARNESS_N synthesized patterns with their masks
    (batches of B): the three methods in fp32 on the kernel route against
    the plain route, sample by sample at HARNESS_TOL, on the published
    SwinWNet (rl_model's weights, whose SR output has peaks for the physics
    to match); then in bf16 with the notebook convention and an AlphaPolicy,
    the schema and finite values, ms a sample by method, and the results
    written with write_results_json and read back. Returns (ms a sample by
    method in bf16, launches in the runs)."""
    images, masks = synthesize_dataset(HARNESS_N, seed=int(rng.integers(1 << 30)))
    loader = ArrayLoader(images, masks, batch_size=B)
    model = rl_model()
    calc = MetricsCalculator(model, loader, verbose=False)
    sb.reset_counts()
    kernel, ms32 = run_harness(calc)
    total = launches()
    with unfused(model):
        plain, _ = run_harness(calc)
    fp32 = torch.float32
    per_batch = add(expected_launches("serve", B, fp32, False, "cmajor"),
                    *[expected_launches("stage2", B, fp32, False, "cmajor")] * 2)
    want = [n * len(loader) for n in per_batch]
    if launches() != total or total != want:
        raise SystemExit(f"harness fp32: launches {total} (gate: {want}), or the plain route launched")
    got_a, want_a = harness_arrays(kernel), harness_arrays(plain)
    if got_a.keys() != want_a.keys():
        raise SystemExit("harness: the two routes give different schemas")
    failed = []
    for k, w in want_a.items():
        g = got_a[k]
        if k.startswith("physics"):
            bad = np.abs(g - w) > HARNESS_TOL["phys"] * np.abs(w)
        else:
            tol = HARNESS_TOL["seg" if k.startswith("seg") else "psnr" if k.endswith("PSNR") else "ssim"]
            bad = np.abs(g - w) > tol
        bad = bad.reshape(len(w), -1).any(axis=1)  # per sample
        worst = float(np.max(np.abs(g - w)))
        print(f"  harness fp32 {k:42s} n={len(w)} max |kernel - plain| {worst:.3e} "
              f"{'ok' if not bad.any() else f'FAIL at samples {np.flatnonzero(bad).tolist()}'}")
        failed += [(k, int(i)) for i in np.flatnonzero(bad)]
    phys = kernel["CalculatePhysycalMetrics"]
    nonzero = int(np.sum(np.asarray(phys["integral"]) > 0))
    print(f"  harness fp32: physics non-zero in {nonzero}/{HARNESS_N} samples; ms by method "
          + ", ".join(f"{m[9:]} {t:.1f}" for m, t in ms32.items()))
    for k, i in failed:
        if k.startswith("physics"):
            batch_images = loader.images[i // B * B:(i // B + 1) * B]
            tk = peak_table(calc, batch_images, i % B)
            with unfused(model):
                tp = peak_table(calc, batch_images, i % B)
            print(f"    sample {i} {k}: kernel {got_a[k][i]:.6g} plain {want_a[k][i]:.6g}; peaks (d, integral) kernel "
                  f"route pred {tk[0]} true {tk[1]}; plain route pred {tp[0]} true {tp[1]}")
    if failed:
        raise SystemExit(f"harness fp32: the kernel route disagrees with the plain route at {failed}")
    del model, calc

    bf16 = torch.bfloat16
    calc = MetricsCalculator(build_model(bf16), loader, verbose=False, policy=rl_policy(), norm_convention="notebook")
    sb.reset_counts()
    res, _ = run_harness(calc)
    total16 = launches()
    _, ms16 = run_harness(calc)  # timed once the first batch's shape is captured
    per_batch = add(expected_launches("serve", B, bf16, False, "cmajor"),
                    *[expected_launches("stage2", B, bf16, False, "cmajor")] * 2)
    want = [n * len(loader) for n in per_batch]
    arrays = harness_arrays(res)
    seg, sr = res[HARNESS_METHODS[0]], res[HARNESS_METHODS[1]]
    schema = (list(seg) == ["Low Res", "High Res"]
              and all(list(seg[r]) == ["0.25 thrashold", "0.50 thrashold", "0.75 thrashold"] for r in seg)
              and list(sr) == ["Summary Metrics", "Only Diffraction Metrics", "Only Error Matrix Metrics"]
              and list(res[HARNESS_METHODS[2]]) == ["integral", "peak", "shape"]
              and all(len(a) == HARNESS_N for a in arrays.values()))
    finite = all(np.isfinite(a).all() for a in arrays.values())
    with tempfile.TemporaryDirectory() as d:
        path = f"{d}/metrics.json"
        payload = {"metrics_50": seg["High Res"]["0.50 thrashold"], "PSNRs": sr["Summary Metrics"]["PSNR"],
                   "Integral Intensity losses": res[HARNESS_METHODS[2]]["integral"]}
        write_results_json(path, payload)
        with open(path) as f:
            back = json.load(f)
    round_trip = (back["metrics_50"] == payload["metrics_50"] and back["PSNRs"] == payload["PSNRs"]
                  and back["Integral Intensity losses"] == payload["Integral Intensity losses"].tolist())
    per_sample = {m: t / HARNESS_N for m, t in ms16.items()}
    ok = schema and finite and round_trip and total16 == want
    print(f"  harness bf16, notebook convention, AlphaPolicy: schema complete {schema}, every value finite {finite}, "
          f"results JSON read back equal {round_trip}, launches {total16} (gate: {want}); ms a sample "
          + ", ".join(f"{m[9:]} {t:.1f}" for m, t in per_sample.items()) + f" {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("harness bf16: incomplete schema, a value not finite, the JSON round trip, or launches")
    return per_sample, add(total, launches())  # both bf16 runs


# ---------------------------------------------------------------------------
# The user's entry points and the rest of the data feed
# ---------------------------------------------------------------------------


def stage_check(tag, got, want, dtype):
    """Every stage of `got` against `want` at PIPE_TOL[dtype]: the seg maps
    absolutely, the other stages relative to their max; returns the worst
    (max, mean) error as fractions of their limits."""
    tol_max, tol_mean = PIPE_TOL[dtype]
    worst = (0.0, 0.0)
    for k in STAGE_NAMES:
        a, b = np.asarray(got[k], np.float64), np.asarray(want[k], np.float64)
        if a.shape != b.shape or not np.isfinite(a).all():
            raise SystemExit(f"{tag}: stage {k} has shape {a.shape} (want {b.shape}) or non-finite values")
        scale = 1.0 if k.startswith("seg") else max(np.abs(b).max(), 1e-30)
        err, mean = np.abs(a - b).max() / scale, np.abs(a - b).mean() / scale
        worst = (max(worst[0], err / tol_max), max(worst[1], mean / tol_mean))
        if err > tol_max or mean > tol_mean:
            raise SystemExit(f"{tag}: stage {k} max {err:.3e} mean {mean:.3e} of its scale, over PIPE_TOL {PIPE_TOL[dtype]}")
    return worst


def check_viewer_csv(path, stage, centers, n_images):
    """The CSV's I(d) columns against a float64 bincount rebin of the saved
    stage's diffraction channel on the host, each within CSV_RTOL of its max."""
    with open(path) as f:
        header = f.readline().strip().split(",")
    table = np.loadtxt(path, delimiter=",", skiprows=1, ndmin=2)
    qw = Qwrapper(fixed_centers=centers, device="cpu")
    idx = qw._indices_for(*stage.shape[2:])
    want = np.stack([np.bincount(idx, weights=img[0].ravel().astype(np.float64), minlength=qw.n_bins + 1)[:qw.n_bins]
                     for img in stage])
    if header != ["d"] + [f"I_{i}" for i in range(n_images)] or table.shape != (qw.n_bins, n_images + 1):
        raise SystemExit(f"viewer: {path} has header {header[:3]}... and shape {table.shape}")
    err = float((np.abs(table[:, 1:] - want.T).max(axis=0) / np.abs(want).max(axis=1)).max())
    if not np.allclose(table[:, 0], qw.centers, rtol=1e-6, atol=0) or err > CSV_RTOL:
        raise SystemExit(f"viewer: {path} differs from the bincount rebin by {err:.2e} of a column's max")
    return err


def viewer_main_path(rng):
    """The viewer CLI at the published width in fp32 on VIEW_B synthesized
    patterns: as a subprocess (`python -m swinwnet_tpu_torch.apps.viewer`),
    then `main(argv)` in-process under the launch counters against the plain
    route and a bincount rebin, then ViewerModel's flow; times VIEW_CALLS
    calls. Returns (ms a main() call, ms a session call, (ms to build the
    model from the .pth, ms to write the stages), subprocess s, launches)."""
    model = build_model(torch.float32)
    images, _ = synthesize_dataset(VIEW_B, seed=int(rng.integers(1 << 30)))
    with tempfile.TemporaryDirectory() as tmp:
        pth, raw, packed = f"{tmp}/m.pth", f"{tmp}/raw.npy", f"{tmp}/dict.npy"
        torch.save({"state_dict": {"module." + k: v.cpu() for k, v in model.state_dict().items()}}, pth)
        np.save(raw, images)
        np.save(packed, {"images": images, "name": "held-out"}, allow_pickle=True)
        files = sorted([f"{k}.npy" for k in STAGE_NAMES] + ["input_id_curves.csv", "masked_hr_id_curves.csv"])

        t0 = time.perf_counter()
        res = subprocess.run([sys.executable, "-m", "swinwnet_tpu_torch.apps.viewer", "--weights", pth,
                              "--input", raw, "--out", f"{tmp}/cli"], capture_output=True, text=True, timeout=300)
        cli_s = time.perf_counter() - t0
        ok = res.returncode == 0 and sorted(os.listdir(f"{tmp}/cli")) == files
        print(f"  python -m swinwnet_tpu_torch.apps.viewer (subprocess, {VIEW_B} images of {H}x{W}): exit "
              f"{res.returncode} in {cli_s:.1f} s, {len(files)} files {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"viewer CLI subprocess failed:\n{res.stdout}\n{res.stderr}")

        argv = ["--weights", pth, "--input", packed, "--out", f"{tmp}/main"]
        want = expected_launches("serve", VIEW_B, torch.float32, False, "cmajor")
        log = io.StringIO()
        per_call, call_ms = [], []
        sb.reset_counts()
        for _ in range(VIEW_CALLS):
            before = launches()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(log):
                viewer.main(argv)
            torch.cuda.synchronize()
            call_ms.append((time.perf_counter() - t0) * 1e3)
            per_call.append([b - a for a, b in zip(before, launches())])
        total = launches()
        # where the rest of a call goes, by function: one more call under cProfile
        prof = cProfile.Profile()
        with contextlib.redirect_stdout(log):
            prof.runcall(viewer.main, argv)
        torch.cuda.synchronize()
        table = io.StringIO()
        pstats.Stats(prof, stream=table).strip_dirs().sort_stats("cumulative").print_stats(14)
        print("  one viewer.main call under cProfile, by cumulative host time:")
        for line in table.getvalue().splitlines():
            if "(" in line and ":" in line:
                print("    " + line.strip()[:150])
        stages = {k: np.load(f"{tmp}/main/{k}.npy") for k in STAGE_NAMES}
        cli = {k: np.load(f"{tmp}/cli/{k}.npy") for k in STAGE_NAMES}
        sniffed = "error_matrix=True" in log.getvalue()
        if any(n != want for n in per_call) or not sniffed:
            raise SystemExit(f"viewer main: launches per call {per_call} (gate: {want}); error_matrix sniffed: {sniffed}")
        # the subprocess read the raw .npy, main() the dict one: the same
        # images; another process may take other library algorithms
        same_as_cli = all(np.array_equal(stages[k], cli[k]) for k in STAGE_NAMES)
        if not same_as_cli:
            stage_check("viewer main vs the subprocess", stages, cli, torch.float32)

        plain_model = SwinWNet(in_chans=1, error_matrix=True, fused_blocks=False, device="cuda", **PUBLISHED)
        plain_model.load_state_dict(load_pth(pth))
        with plain_levels():
            plain = ViewerSession(plain_model).run(images)
        worst = stage_check("viewer main vs fused_blocks=False", stages, plain, torch.float32)
        errs = [check_viewer_csv(f"{tmp}/main/input_id_curves.csv", stages["images"], d_centers_lr, VIEW_B),
                check_viewer_csv(f"{tmp}/main/masked_hr_id_curves.csv", stages["images_masked_hr"], d_centers_hr, VIEW_B)]
        print(f"  viewer.main in-process x{VIEW_CALLS}: launches per call {per_call} (gate: {want}), error_matrix "
              f"sniffed True; 8 stages against fused_blocks=False at {worst[0]:.2f} / {worst[1]:.2f} of PIPE_TOL "
              f"(max / mean); I(d) CSVs against a float64 bincount of the saved stages {errs[0]:.1e}, {errs[1]:.1e} "
              f"of a column's max (tol {CSV_RTOL:.0e}); the subprocess's stages "
              f"{'bit for bit' if same_as_cli else 'within PIPE_TOL, not bit for bit'} ok")

        vm = ViewerModel()
        vm.load_weights(pth)
        sb.reset_counts()
        if not (vm.load_npy(packed) and vm.run_inference()):
            raise SystemExit(f"ViewerModel: {vm.status}")
        total = add(total, launches())
        for k in ("images", "images_masked_hr"):
            vm.toggle_stage_selected(k, True)
        n_csv = vm.export_csv(f"{tmp}/model.csv")
        # where a main() call's time goes: the model built from the .pth, and
        # the 8 stage arrays written
        t0 = time.perf_counter()
        viewer.load_model_any(pth)
        torch.cuda.synchronize()
        load_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        for k in STAGE_NAMES:
            np.save(f"{tmp}/{k}.npy", stages[k])
        write_ms = (time.perf_counter() - t0) * 1e3
        bits = all(np.array_equal(vm.data[k], stages[k]) for k in STAGE_NAMES)
        if not bits:  # hold it at PIPE_TOL and say by how much it differs
            stage_check("ViewerModel vs the CLI", vm.data, stages, torch.float32)
        ok = vm.error_matrix is True and n_csv == 2 and vm.stage_order == list(STAGE_NAMES)
        print(f"  ViewerModel load_weights -> load_npy -> run_inference -> export_csv: {n_csv} series, stages "
              f"{'bit for bit the CLI' if bits else 'NOT bit for bit the CLI (within PIPE_TOL)'}; "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit("ViewerModel: the flow did not give the CLI's stages and two CSV series")

    session = ViewerSession(model)
    session_ms = []
    for _ in range(VIEW_CALLS + 1):
        t0 = time.perf_counter()
        out = session.run(images)
        session.curves(out["images"]), session.curves(out["images_masked_hr"], high_res=True)
        torch.cuda.synchronize()
        session_ms.append((time.perf_counter() - t0) * 1e3)
    del model, plain_model, vm, session
    return call_ms, session_ms[1:], (load_ms, write_ms), cli_s, total


def batcher_main_path(rng):
    """NativeBatcher feeding SegmentatorTrainer one epoch of BATCHER_N
    synthesized patterns (batches of TRAIN_B, the train-noise protocol) in
    fp32 with fused_blocks and fused_deep; its determinism, the eval-noise
    protocol, ms a batch against ArrayLoader, and the steps each feeds, in
    turns. Returns (build s, step ms, {loader: step ms in the turns}, batch
    ms, ArrayLoader batch ms, launches)."""
    t0 = time.perf_counter()
    lib = native_loader.build()
    build_s = time.perf_counter() - t0
    print(f"  built {lib.name} in {build_s:.2f} s")
    images, masks = synthesize_dataset(BATCHER_N, seed=int(rng.integers(1 << 30)))
    model = build_model(torch.float32, fused_deep=True).train()
    nb = NativeBatcher(images, masks, batch_size=TRAIN_B, add_noise=True, seed=SEED)
    loader = ProbeLoader(nb, model)
    trainer = SegmentatorTrainer(model, loader, num_epochs=1, warmup_epochs=1, verbose=False)
    losses, step = [], trainer.train_step

    def noted_step(*batch):
        losses.append(step(*batch))
        return losses[-1]

    trainer.train_step = noted_step
    sb.reset_counts()
    trainer.train()
    total = launches()
    nb.close()
    steps = loader.steps(0)
    want = expected_launches("stage1", TRAIN_B, torch.float32, True, "cmajor")
    finite = len(losses) == BATCHER_N // TRAIN_B and all(bool(torch.isfinite(v)) for v in losses)
    ok = finite and [n for _, n in steps] == [want] * (BATCHER_N // TRAIN_B)
    print(f"  SegmentatorTrainer, one epoch from NativeBatcher: {len(steps)} steps, launches per step "
          f"{[n for _, n in steps]} (gate: {want}), losses {[round(float(v), 5) for v in losses]} "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("batcher-fed stage 1: launches differ from the gate's or a loss is not finite")
    # the steps fed by each loader, in turns on the same model: ArrayLoader
    # (the same augmentation, on the trainer's thread), NativeBatcher, ...
    turns = {"ArrayLoader": [], "NativeBatcher": []}
    for kind in ("ArrayLoader", "NativeBatcher") * 2:
        feed = (ArrayLoader(images, masks, batch_size=TRAIN_B, shuffle=True, augment=make_train_noise_augment())
                if kind == "ArrayLoader" else NativeBatcher(images, masks, batch_size=TRAIN_B, add_noise=True, seed=SEED))
        probe = ProbeLoader(feed, model)
        SegmentatorTrainer(model, probe, num_epochs=1, warmup_epochs=1, verbose=False).train()
        turns[kind] += [ms for ms, _ in probe.steps(0)]
        if kind == "NativeBatcher":
            feed.close()

    a, b = (NativeBatcher(images, masks, batch_size=TRAIN_B, add_noise=True, seed=SEED) for _ in range(2))
    same = all(all(np.array_equal(x, y) for x, y in zip(a.next(), b.next())) for _ in range(2 * len(a)))
    batch_ms = []
    for _ in range(BATCHER_TIMED):
        t0 = time.perf_counter()
        a.next()
        batch_ms.append((time.perf_counter() - t0) * 1e3)
    a.close()
    b.close()
    ev = NativeBatcher(np.zeros((TRAIN_B, H, W), np.float32), None, batch_size=TRAIN_B, shuffle=False, add_noise=True,
                       noise_mu_range=(100.0, 100.0), sigma_frac=0.2, seed=1)
    x = ev.next()[0]
    ev.close()
    mu, sd = float(x.mean()), float(x.std())
    ref = ArrayLoader(images, masks, batch_size=TRAIN_B, shuffle=True, augment=make_train_noise_augment())
    ref_ms = []
    while len(ref_ms) < BATCHER_TIMED:
        t0 = time.perf_counter()
        for _ in ref:
            ref_ms.append((time.perf_counter() - t0) * 1e3)
            t0 = time.perf_counter()
    ok = same and abs(mu - 100.0) < 1.0 and abs(sd - 20.0) < 1.0
    print(f"  two batchers with one seed: {2 * len(nb)} batches identical {same}; the eval-noise protocol on "
          f"[{TRAIN_B}, {H}, {W}] zeros: mean {mu:.3f}, std {sd:.3f} (N(100, 20), within 1) "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("NativeBatcher: not deterministic, or the eval-noise protocol is off")
    del model, trainer
    return build_s, [ms for ms, _ in steps], turns, batch_ms, ref_ms, total


def check_calibration():
    """detect_table, extract_crystal_spec and refine_crystal_spec(iters=2)
    on a render_calibrated pattern with the Qwrapper on the card and on the
    CPU: the same peaks, d within one LR bin. Returns ms by device."""
    d_list, inten = [0.62, 1.2, 2.1, 3.3, 4.6], [0.5, 1.0, 0.6, 0.8, 0.4]
    img = render_calibrated(d_list, inten, seed=SEED)
    clean = synthesize_pattern(d_list, inten, seed=None, background=0.0)
    mask = (clean > clean.max() * 5e-3).astype(np.float32)

    def run(device):
        table = detect_table(img, mask, device=device)
        spec = extract_crystal_spec(img, mask, device=device)
        return table, spec, refine_crystal_spec(spec, img, mask, iters=2, device=device)

    out, ms = {}, {}
    for dev in ("cuda", "cpu"):
        run(dev)  # warm-up: index maps, allocator
        t0 = time.perf_counter()
        out[dev] = run(dev)
        torch.cuda.synchronize()
        ms[dev] = (time.perf_counter() - t0) * 1e3
    bin_lr = float(d_centers_lr[1] - d_centers_lr[0])
    (tc, sc, rc), (tp, sp, rp) = out["cuda"], out["cpu"]
    d_table = lambda t: np.array([p["d_com"] for p in t])
    pairs = [(d_table(tc), d_table(tp)), (sc["d"], sp["d"]), (np.asarray(rc["d"]), np.asarray(rp["d"]))]
    ok = all(len(a) == len(b) > 0 for a, b in pairs)
    worst = max(float(np.abs(a - b).max()) for a, b in pairs) if ok else np.inf
    ok = ok and worst <= bin_lr
    print(f"  calibration on a render_calibrated [{H}, {W}] pattern: {len(tc)} peaks in the table, {len(sc['d'])} in "
          f"the spec, {len(rc['d'])} arcs refined (iters=2); cuda against cpu: d within {worst:.2e} A (one LR bin "
          f"{bin_lr:.2e}); {ms['cuda']:.1f} ms on cuda, {ms['cpu']:.1f} ms on cpu {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("calibration: the card's peak tables differ from the CPU's")
    return ms


# ---------------------------------------------------------------------------
# [17] the model's remaining features, [18] data parallelism
# ---------------------------------------------------------------------------


def leaf_gaps(got, want):
    """Each leaf's max|got - want| over its max|want|."""
    gaps = {}
    for k, g in want.items():
        scale = g.abs().max().item()
        diff = (got[k] - g).abs().max().item()
        gaps[k] = diff / scale if scale else diff
    return gaps


def grad_gap(got, want):
    """The worst leaf's max|got - want| over its max|want|, and its name."""
    gaps = leaf_gaps(got, want)
    name = max(gaps, key=gaps.get)
    return gaps[name], name


def same_bits(got, want):
    """The leaves of `got` whose bits differ from `want`'s."""
    return [k for k in want if not torch.equal(got[k], want[k])]


def remat_agrees(remat, plain, again):
    """The plain step run twice gives the same bits in every leaf; remat's
    gradients are within REMAT_GRAD_TOL of each leaf's max of the plain
    step's. Returns (ok, report)."""
    gaps, differ = leaf_gaps(remat, plain), same_bits(again, plain)
    worst = max(gaps, key=gaps.get)
    over = [k for k, g in gaps.items() if g > REMAT_GRAD_TOL]
    return not over and not differ and remat.keys() == plain.keys() == again.keys(), (
        f"worst {gaps[worst]:.2e} of its max ({worst}), {len(over)} leaves above {REMAT_GRAD_TOL:.0e}; the plain "
        f"step run twice: {len(plain) - len(differ)} of {len(plain)} leaves the same bits"
        + (f" (differ: {differ[:4]})" if differ else ""))


def grads_of(model):
    return {k: p.grad.detach().clone() for k, p in model.named_parameters() if p.grad is not None}


def remat_steps(batch):
    """One stage-3 odd step in fp32 at TRAIN_B without fused_deep (the JAX
    default: the C = 96-384 levels unfused), with remat and without, from
    the same weights; then a second step of each, timed, with its peak
    memory. Returns the launches."""
    want = expected_launches("stage3_odd", TRAIN_B, torch.float32, False, "cmajor")
    runs, total = {}, [0, 0, 0]
    for key in ("plain", "plain again", "remat"):
        model = build_model(torch.float32, remat=key == "remat").train()
        trainer = FullModelTrainer(model, [batch], num_epochs=1, warmup_epochs=1, verbose=False)
        sb.reset_counts()
        loss = float(trainer.train_step(*batch, even=False)["loss"])
        torch.cuda.synchronize()
        n = launches()
        grads = grads_of(model)
        ms = peak = None
        if key != "plain again":
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            trainer.train_step(*batch, even=False)
            torch.cuda.synchronize()
            ms, peak = (time.perf_counter() - t0) * 1e3, torch.cuda.max_memory_allocated() / 2 ** 30
        runs[key] = (loss, grads, n, ms, peak)
        total = add(total, launches())
        del model, trainer
    (l0, g0, n0, ms0, m0), (l1, g1, n1, ms1, m1) = runs["plain"], runs["remat"]
    same, report = remat_agrees(g1, g0, runs["plain again"][1])
    rel = abs(l1 - l0) / abs(l0)
    ok = (np.isfinite(l0) and rel <= REMAT_LOSS_RTOL and same and runs["plain again"][0] == l0
          and n0 == n1 == runs["plain again"][2] == want)
    print(f"  remat, stage-3 odd step fp32 B={TRAIN_B} without fused_deep: loss {l1:.6f} vs {l0:.6f} without "
          f"(rel {rel:.1e}, tol {REMAT_LOSS_RTOL:.0e}), the plain step again {runs['plain again'][0]:.9g} vs "
          f"{l0:.9g}; {len(g0)} gradients, {report}; launches {n1} and {n0} (gate: {want}) {'ok' if ok else 'FAIL'}")
    print(f"  second step: remat {ms1:.1f} ms, peak {m1:.2f} GiB; without {ms0:.1f} ms, peak {m0:.2f} GiB")
    if not ok:
        raise SystemExit("remat: the step disagrees with the step without it")
    return total


def dropout_step(model, images, masks, seed):
    """stage3_odd_loss at deterministic=False with a generator on the card
    seeded `seed`, and its backward: (loss, gradients, launches)."""
    model.zero_grad(set_to_none=True)
    before = launches()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    total, _ = stage3_odd_loss(model, combined_loss, smooth_l1_loss, (1.0, 1.0, 1.0), images, masks,
                               deterministic=False, generator=gen)
    total.backward()
    torch.cuda.synchronize()
    return float(total.detach()), grads_of(model), [b - a for a, b in zip(before, launches())]


def dropout_checks(rng):
    """drop = attn_drop = drop_path = 0.1: at deterministic=True a bf16
    serving call equals the rates-0 model's bit for bit through the gate's
    launches; at deterministic=False nothing fuses, one seed gives one loss,
    two seeds two, remat repeats the forward's masks; the keep fraction of
    one [8, 2, 250, 480] draw. Returns the launches."""
    request = rng.uniform(0, 1e3, (B, 2, H, W)).astype(np.float32)
    stages, total = {}, [0, 0, 0]
    for rates in ({}, DROP_RATES):
        infer = SwinWNetInference(build_model(torch.bfloat16, **rates))
        infer(request)
        torch.cuda.synchronize()
        sb.reset_counts()
        infer(request)
        torch.cuda.synchronize()
        stages[bool(rates)] = ({k: getattr(infer, k).clone() for k in STAGE_NAMES}, launches())
        total = add(total, launches())
        del infer
    same = all(torch.equal(stages[True][0][k], stages[False][0][k]) for k in STAGE_NAMES)
    want = [LAUNCHES_PER_CALL[torch.bfloat16], 0, 0]
    ok = same and stages[True][1] == stages[False][1] == want
    print(f"  deterministic=True, bf16 B={B}: the 8 stages of the rates-0.1 model equal the rates-0 model's bit "
          f"for bit: {same}; launches {stages[True][1]} and {stages[False][1]} (gate: {want}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("dropout at deterministic=True changed the serving call")

    images, masks = training_batches(1, DROP_B, rng)[0]
    images = ensure_2ch(torch.from_numpy(images).cuda())
    masks = torch.from_numpy(masks).cuda()[:, None]
    runs = {}
    for remat in (False, True):
        model = build_model(torch.float32, remat=remat, **DROP_RATES).train()
        t0 = time.perf_counter()
        runs[remat] = dropout_step(model, images, masks, seed=0)
        ms = (time.perf_counter() - t0) * 1e3
        runs[remat] += (ms,)
        if remat:  # the control: other masks, as a recompute that redrew them would have
            g_other = dropout_step(model, images, masks, seed=1)[1]
        else:
            again, g_again, _ = dropout_step(model, images, masks, seed=0)
            other = dropout_step(model, images, masks, seed=1)[0]
        del model
    (l0, g0, n0, ms0), (l1, g1, n1, ms1) = runs[False], runs[True]
    gap, name = grad_gap(g1, g0)
    differ, control = same_bits(g_again, g0), grad_gap(g_other, g0)[0]
    rel = abs(l1 - l0) / abs(l0)
    ok = (np.isfinite(l0) and n0 == n1 == [0, 0, 0] and again == l0 and other != l0 and not differ
          and rel <= REMAT_LOSS_RTOL and g1.keys() == g0.keys() and gap <= REMAT_GRAD_TOL < control)
    print(f"  deterministic=False, stage-3 odd step fp32 B={DROP_B}: loss {l0:.9g} (seed 0), {again:.9g} (seed 0 "
          f"again), {other:.6f} (seed 1); launches {n0}; seed 0 twice: {len(g0) - len(differ)} of {len(g0)} leaves "
          f"the same bits; with remat loss {l1:.6f} (rel {rel:.1e}), gradients worst {gap:.2e} of its max ({name}; "
          f"tol {REMAT_GRAD_TOL:.0e}); the control, remat with seed 1's masks, {control:.2e} {'ok' if ok else 'FAIL'}")
    print(f"  the dropout step {ms0:.1f} ms, with remat {ms1:.1f} ms (first steps)")
    if not ok:
        raise SystemExit("dropout at deterministic=False: a check failed")

    gen = torch.Generator(device="cuda").manual_seed(2)
    kept = (layers_mod.dropout(torch.ones(TRAIN_B, 2, H, W, device="cuda"), 0.1, False, gen) != 0)
    frac = kept.float().mean().item()
    print(f"  kept fraction of one [{TRAIN_B}, 2, {H}, {W}] draw at rate 0.1: {frac:.5f} "
          f"{'ok' if abs(frac - 0.9) <= 0.005 else 'FAIL'}")
    if abs(frac - 0.9) > 0.005:
        raise SystemExit("dropout keeps the wrong fraction")
    return total


def nondeterministic_ops(batch):
    """One fp32 step of each training stage (fused_blocks, no fused_deep)
    under torch.use_deterministic_algorithms(True, warn_only=True): the
    first line of each warning by stage. The mode is switched off again
    whatever happens."""
    found = {}
    for kind in ("stage1", "stage2", "stage3_even", "stage3_odd"):
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                first_step(kind, batch, plain=False)
        finally:
            torch.use_deterministic_algorithms(False)
        found[kind] = sorted({str(w.message).strip().splitlines()[0][:200] for w in caught})
        print(f"  {kind:11s} under use_deterministic_algorithms(warn_only=True): {len(found[kind])} kinds of warning")
        for msg in found[kind]:
            print(f"    {msg}")
    return found


# the resize's two products against F.interpolate: factors 2 and 4 make
# every lerp weight exact in both, so the forms differ by the rounding of
# a two-term sum, 1e-6 of the max (tests/test_torch_port_resize.py)
RESIZE_TOL = 1e-6


def resize_checks(gen):
    """The segmentation heads' two resizes, [b, 1, 125, 240] up 2 and 4, at
    b = B and SEG_B: the forward against F.interpolate; forward, and forward
    and backward, timed both ways (CUDA events); whether two backward passes
    of one cotangent give the same bits, both ways. Returns the times."""
    times = {}
    for batch in (B, SEG_B):
        for up in (2, 4):
            out_hw = (125 * up, 240 * up)
            x = torch.randn(batch, 1, 125, 240, generator=gen).cuda()
            g = torch.randn(batch, 1, *out_hw, generator=gen).cuda()
            forms = {"two products": lambda t: bilinear_resize(t, *out_hw),
                     "F.interpolate": lambda t: F.interpolate(t, size=out_hw, mode="bilinear", align_corners=False)}
            row, bits = {}, {}
            for name, f in forms.items():
                xr = x.clone().requires_grad_(True)

                def fwd_bwd():
                    xr.grad = None
                    f(xr).backward(g)

                row[name] = (cuda_ms(lambda: f(x), 10), cuda_ms(fwd_bwd, 10))
                grads = []
                for _ in range(2):
                    fwd_bwd()
                    grads.append(xr.grad.clone())
                bits[name] = torch.equal(grads[0], grads[1])
            want = forms["F.interpolate"](x)
            err = (bilinear_resize(x, *out_hw) - want).abs().max().item() / want.abs().max().item()
            times[(batch, up)] = row
            ok = err <= RESIZE_TOL and bits["two products"]
            print(f"  resize [{batch}, 1, 125, 240] x{up}: two products fwd {row['two products'][0]:.4f} ms, fwd+bwd "
                  f"{row['two products'][1]:.4f} ms; F.interpolate fwd {row['F.interpolate'][0]:.4f} ms, fwd+bwd "
                  f"{row['F.interpolate'][1]:.4f} ms; forward {err:.2e} of max apart (tol {RESIZE_TOL:.0e}); two "
                  f"backward passes the same bits: two products {bits['two products']}, F.interpolate "
                  f"{bits['F.interpolate']} {'ok' if ok else 'FAIL'}")
            if not ok:
                raise SystemExit("the bilinear resize disagrees with F.interpolate or its backward is not deterministic")
    return times


def shift_and_chunk_checks():
    """A shifted level on the card against the same module on the CPU, at
    encoder L0's grid and at one that does not tile; attn_chunk=64 against
    unchunked on an unfused level, with their times."""
    gen = torch.Generator().manual_seed(SEED)
    layer = BasicLayer(48, 2, 3, shift_size=2).eval()
    init_weights(layer, gen)
    times = {}
    for grid in ((125, 240), (63, 120)):
        x = torch.randn(B, *grid, 48, generator=gen)
        with torch.no_grad():
            want = layer.cpu()(x)
            layer.cuda()
            xc = x.cuda()
            got = layer(xc).cpu()
            times[grid] = cuda_ms(lambda: layer(xc), 5)
        err = (got - want).abs().max().item() / want.abs().max().item()
        print(f"  shifted BasicLayer(48, 3 heads, shift 2) at [{B}, {grid[0]}, {grid[1]}, 48] fp32, cuda against "
              f"cpu: {err:.2e} of max (tol {SHIFT_TOL:.0e}), {times[grid]:.3f} ms on the card "
              f"{'ok' if err <= SHIFT_TOL else 'FAIL'}")
        if err > SHIFT_TOL:
            raise SystemExit("the shifted level disagrees between cuda and cpu")
    plain_layer = BasicLayer(48, 2, 3).eval().cuda()
    plain_layer.load_state_dict(layer.state_dict())
    xc = torch.randn(B, 125, 240, 48, generator=gen).cuda()
    with torch.no_grad():
        times["unshifted"] = cuda_ms(lambda: plain_layer(xc), 5)
    print(f"  the same level unshifted (unfused) {times['unshifted']:.3f} ms")

    plain = BasicLayer(96, 2, 6).eval()
    init_weights(plain, gen)
    chunked = BasicLayer(96, 2, 6, attn_chunk=64).eval()
    chunked.load_state_dict(plain.state_dict())
    plain.cuda()
    chunked.cuda()
    x = torch.randn(TRAIN_B, 63, 120, 96, generator=gen).cuda()
    peaks = {}
    with torch.no_grad():
        for name, mod in (("unchunked", plain), ("attn_chunk=64", chunked)):
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            mod(x)
            torch.cuda.synchronize()
            peaks[name] = (torch.cuda.max_memory_allocated() - base) / 2 ** 20
            times[name] = cuda_ms(lambda: mod(x), 5)
        want, got = plain(x), chunked(x)
    err = (got - want).abs().max().item() / want.abs().max().item()
    print(f"  attn_chunk=64 at encoder L1's [{TRAIN_B}, 63, 120, 96] (unfused in fp32): {err:.2e} of max (tol "
          f"{SHIFT_TOL:.0e}); {times['attn_chunk=64']:.3f} ms, {peaks['attn_chunk=64']:.0f} MiB above the input, "
          f"unchunked {times['unchunked']:.3f} ms, {peaks['unchunked']:.0f} MiB {'ok' if err <= SHIFT_TOL else 'FAIL'}")
    if err > SHIFT_TOL:
        raise SystemExit("attn_chunk changes the level's output")


def dp_reference(hw, batch, steps=1):
    """The dry run's odd step (make_stage3_steps) in this process on the
    full batch, on the card, run eagerly, `steps` times: (the last step's
    loss terms, gradients, parameters after)."""
    model = SwinWNet(**dryrun_mod.PUBLISHED, device="cuda", generator=torch.Generator().manual_seed(0))
    images, masks = dryrun_batch(batch, hw)
    tx = masked_adamw(model, "stage3", dryrun_mod.LR)
    state = TrainState.create(model, tx)
    _, odd_step, _, _ = make_stage3_steps(model, tx, combined_loss, smooth_l1_loss, *dryrun_mod.WEIGHTS)
    with graphs.run_eagerly():
        for _ in range(steps):
            state, aux = odd_step(state, images, masks)
    torch.cuda.synchronize()
    terms = {k: float(aux[k]) for k in ("loss", "seg_lr", "seg_hr", "iou_hr")}
    named = list(model.named_parameters())
    return terms, {k: p.grad.cpu() for k, p in named}, {k: p.detach().cpu() for k, p in named}


def compare_captured_dp(out, ref, n, steps):
    """The NCCL dry run's replayed steps against the same steps in one
    process on the full batch, run eagerly: the same bits; else (cuBLAS may
    take another algorithm under capture) the loss to REMAT_LOSS_RTOL, each
    gradient to REMAT_GRAD_TOL of its leaf's max (TRAIN_GRAD_TOL over more
    than one rank, whose sum runs in another order), each parameter within
    2 lr a step."""
    terms, grads, params = ref
    bits = (out["loss"] == terms["loss"] and all(torch.equal(out["grads"][k], g) for k, g in grads.items())
            and all(torch.equal(out["params"][k], p) for k, p in params.items()))
    loss_rel = abs(out["loss"] - terms["loss"]) / abs(terms["loss"])
    gap, gap_name = grad_gap(out["grads"], grads)
    moved = max((out["params"][k] - p).abs().max().item() for k, p in params.items())
    ok = bits or (loss_rel <= REMAT_LOSS_RTOL and gap <= (REMAT_GRAD_TOL if n == 1 else TRAIN_GRAD_TOL)
                  and moved <= 2 * steps * dryrun_mod.LR)
    PROGRAM_BITS[f"dry run NCCL x{n}"] = bits
    print(f"  against the same {steps} steps in one process, run eagerly: "
          + ("the same bits in the loss, every gradient and every parameter" if bits else
             f"loss rel {loss_rel:.1e}, gradients worst {gap:.2e} of its max ({gap_name}), parameters apart "
             f"{moved:.2e} at most")
          + f" {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("the dry run's captured steps disagree with the eager steps")


def compare_dp(out, ref):
    """The sharded step against the one-process step: loss rtol 1e-5,
    gradients 1e-3 of each leaf's max, parameters rtol 1e-5 / atol 1e-6
    where |g| >= 1e-7 (ten times AdamW's eps) and within 2 lr elsewhere,
    fewer than 1e-3 of the elements outside rtol / atol."""
    terms, grads, params = ref
    loss_rel = abs(out["loss"] - terms["loss"]) / abs(terms["loss"])
    gap, gap_name = grad_gap(out["grads"], grads)
    off = n = changed = 0
    bad = []
    for k, want in params.items():
        diff = (out["params"][k] - want).abs()
        outside = diff > 1e-6 + 1e-5 * want.abs()
        if bool((outside & (grads[k].abs() >= 10 * ADAM_EPS)).any()) or not bool((diff <= 2 * dryrun_mod.LR).all()):
            bad.append(k)
        off += int(outside.sum())
        n += want.numel()
    ok = (loss_rel <= 1e-5 and gap <= TRAIN_GRAD_TOL and not bad and off < 1e-3 * n
          and abs(out["iou_hr"] - terms["iou_hr"]) <= 1e-6)
    print(f"  against one process on the full batch: loss {out['loss']:.6f} vs {terms['loss']:.6f} (rel "
          f"{loss_rel:.1e}); gradients worst {gap:.2e} of its max ({gap_name}); parameters outside rtol 1e-5 / "
          f"atol 1e-6: {off} of {n}, all where |g| < 1e-7 and within 2 lr: {not bad}; iou_hr {out['iou_hr']:.6f} vs "
          f"{terms['iou_hr']:.6f} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"the sharded step disagrees with the one-process step: {bad[:5]}")


def dp_checks():
    """dryrun_multichip over every card (NCCL) through make_stage3_steps'
    odd step, two steps so that the second replays the captured step with
    its all-reduce, against the same steps in one process; then two ranks on
    one card over gloo at the full size against one process on the full
    batch."""
    n = torch.cuda.device_count()
    t0 = time.perf_counter()
    out = dryrun_multichip(n, steps=2)
    wall = time.perf_counter() - t0
    print(f"  dryrun_multichip({n}, steps=2), NCCL, published width, [{n}, 2, 80, 120], make_stage3_steps' odd "
          f"step with the mean over the mesh in it: loss {out['loss']:.6f} (seg_lr {out['seg_lr']:.6f}, seg_hr "
          f"{out['seg_hr']:.6f}, iou_hr {out['iou_hr']:.4f}); the steps {[round(t, 1) for t in out['steps_ms']]} ms "
          f"(the warm-up and capture, then a replay), the call {wall:.1f} s with the ranks' start")
    compare_captured_dp(out, dp_reference((80, 120), n, steps=2), n, 2)
    t0 = time.perf_counter()
    two = dryrun_multichip(2, backend="gloo", hw=(H, W))
    wall2 = time.perf_counter() - t0
    print(f"  two ranks on one card over gloo, [2, 2, {H}, {W}] a sample a rank: the step {two['step_ms']:.1f} ms, "
          f"the call {wall2:.1f} s; run eagerly (core.graphs.run_eagerly: gloo copies CUDA tensors through the "
          f"host, which no graph can capture)")
    t0 = time.perf_counter()
    ref = dp_reference((H, W), 2)
    ref_ms = (time.perf_counter() - t0) * 1e3
    compare_dp(two, ref)
    print(f"  the one-process step with the model's build {ref_ms:.1f} ms")


# ---------------------------------------------------------------------------
# [19] The user's recipes
# ---------------------------------------------------------------------------

# the flagship recipe's data at full geometry, cut to two steps a stage: 8
# train crystals x 1 render (batches of RECIPE_B), the 6 held-out x 1, one
# noise pass
RECIPE_B = 4
RECIPE_DATA = ["--train-crystals", "8", "--renders-per-crystal", "1", "--eval-renders-per-crystal", "1",
               "--noise-passes", "1", "--batch", str(RECIPE_B)]
QUALITY_FLAGS = ["--compute-dtype", "bf16", "--sr-loss", "SmoothL1SSIMLoss", "--keep-best", "--flip-augment",
                 "--fused-blocks", "--seg-epochs", "1", "--sr-epochs", "1", "--full-epochs", "1", *RECIPE_DATA]
# a bf16 first step through the kernels against the same step through their
# plain versions: the two forwards round each bf16 product at the same
# points but their fp32 sums differ in order, so an output can round to the
# neighbouring bf16 value (2^-8 relative); the loss, a mean over every
# pixel, to 2e-2 relative (about five bf16 steps at the worst pixel, as
# BLOCK_TOL). Each gradient leaf is held to the gap bf16 itself opens: the
# kernel step's distance from the plain bf16 step, over its max, within
# twice the plain bf16 step's distance from the fp32 step, or
# BF16_GRAD_FLOOR where that is smaller. A one-element leaf (a
# cross-attention gamma) is a sum over every token of products of either
# sign that nearly cancel: its rounding error scales with the terms'
# magnitudes, not with the result (TRAIN_SCALAR_GRAD_TOL's reason in fp32),
# and it gets five times the floor
BF16_LOSS_RTOL, BF16_GRAD_FLOOR, BF16_SCALAR_GRAD_FLOOR = 2e-2, 2e-2, 1e-1


def summary_keys(script):
    """The keys of the `summary = {...}` literal of scripts/<script>.py, the
    JAX script the recipe ports (read as text; nothing of it is imported)."""
    with open(os.path.join(REPO_ROOT, "scripts", f"{script}.py")) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and any(isinstance(t, ast.Name) and t.id == "summary" for t in node.targets)):
            return [k.value for k in node.value.keys]
    raise SystemExit(f"scripts/{script}.py has no summary literal")


def key_tree(x, depth=3):
    if depth == 0:
        return None
    if isinstance(x, dict):
        return {k: key_tree(v, depth - 1) for k, v in x.items()}
    if isinstance(x, list) and x and isinstance(x[0], dict):
        return [key_tree(x[0], depth - 1)]
    return None


def read_json(path):
    with open(os.path.join(REPO_ROOT, path)) as f:
        return json.load(f)


class StepProbe:
    """Wraps the three supervised trainers' and RLTrainer's `train_step` and
    the serving programs the harness and the diagnostics make: each call's
    host ms after a synchronize, launches per kernel, batch, peak memory
    and a step's loss. Keeps the first batch of each kind of step."""

    def __init__(self):
        self.steps, self.serving, self.first_batch, self.losses = [], [], {}, []

    def _measure(self, fn, *a, **kw):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before, t0 = launches(), time.perf_counter()
        out = fn(*a, **kw)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        return out, ms, [b - a_ for a_, b in zip(before, launches())], torch.cuda.max_memory_allocated() / 2 ** 30

    @contextlib.contextmanager
    def installed(self):
        from swinwnet_tpu_torch.evalharness import harness as harness_mod
        from swinwnet_tpu_torch.recipes import quality_run as qr_mod

        probe = self
        trainers = {SegmentatorTrainer: "stage1", UpscalerTrainer: "stage2", FullModelTrainer: "stage3",
                    RLTrainer: "rl"}
        saved = [(cls, "train_step", cls.train_step) for cls in trainers]
        saved += [(mod, "make_inference_fn", mod.make_inference_fn) for mod in (harness_mod, qr_mod)]
        for cls, kind in trainers.items():
            def step(self, *a, _orig=cls.train_step, _kind=kind, **kw):
                kind = _kind if _kind != "stage3" else ("stage3_even" if kw["even"] else "stage3_odd")
                probe.first_batch.setdefault(kind, tuple(np.array(x) for x in a))
                out, ms, n, peak = probe._measure(_orig, self, *a, **kw)
                dtype = torch.float32 if self.compute_dtype is None else resolve_dtype(self.compute_dtype)
                probe.steps.append((kind, ms, n, len(a[0]), peak, dtype))
                probe.losses.append(float(out["sup_loss" if kind == "rl" else "loss"] if isinstance(out, dict) else out))
                return out
            cls.train_step = step
        for mod in (harness_mod, qr_mod):
            def make_fn(model, _orig=mod.make_inference_fn, **kw):
                program = _orig(model, **kw)

                def stages(images):
                    out, ms, n, _ = probe._measure(program, images)
                    probe.serving.append((ms, n, len(images), model.dtype))
                    return out
                return stages
            mod.make_inference_fn = make_fn
        try:
            yield self
        finally:
            for owner, name, orig in saved:
                setattr(owner, name, orig)

    def check(self, tag, kinds):
        """Every step's and serving call's launches against the gate;
        returns {kind: [ms, ...]} and {kind: peak GiB}."""
        ms, peak = {}, {}
        for kind, t, n, batch, gib, dtype in self.steps:
            want = expected_launches(kind, batch, dtype, False, "cmajor")
            if n != want:
                raise SystemExit(f"{tag}: a {kind} step at B={batch} launched {n}, the gate implies {want}")
            ms.setdefault(kind, []).append(t)
            peak[kind] = max(peak.get(kind, 0.0), gib)
        for t, n, batch, dtype in self.serving:
            want = expected_launches("serve", batch, dtype, False, "cmajor")
            if n != want:
                raise SystemExit(f"{tag}: a serving call at B={batch} launched {n}, the gate implies {want}")
        if set(ms) != set(kinds) or not np.isfinite(self.losses).all():
            raise SystemExit(f"{tag}: steps of {sorted(ms)} (expected {sorted(kinds)}), losses {self.losses}")
        return ms, peak


def bf16_first_step(kind, batch, route):
    """One bf16 step (compute_dtype) of the recipe's published model (remat,
    attn_chunk=8192, the cross-attention live) from the seed's weights, with
    the recipe's SmoothL1SSIMLoss; `route` is "kernel", "plain" (the blocks
    through their plain versions) or "fp32" (the plain route in fp32).
    Returns (loss, gradients, launches, parameters before, after, ms of
    the step)."""
    model = build_model(torch.float32, remat=True, attn_chunk=8192).train()
    cls = {"stage1": SegmentatorTrainer, "stage2": UpscalerTrainer}.get(kind, FullModelTrainer)
    kw = {"loss": "SmoothL1SSIMLoss"} if cls is UpscalerTrainer else (
        {"upscaler_loss": "SmoothL1SSIMLoss"} if cls is FullModelTrainer else {})
    trainer = cls(model, [batch], num_epochs=1, warmup_epochs=1, verbose=False,
                  compute_dtype=None if route == "fp32" else "bfloat16", **kw)
    before, n0 = snapshot(model), launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with plain_blocks() if route != "kernel" else contextlib.nullcontext():
        if cls is FullModelTrainer:
            loss = trainer.train_step(*batch, even=kind == "stage3_even")["loss"]
        else:
            loss = trainer.train_step(*batch)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    n = [b - a for a, b in zip(n0, launches())]
    return float(loss), grads_of(model), n, before, snapshot(model), ms


def compare_bf16_first_steps(probe):
    """Each stage's first bf16 step with the kernels against the plain
    versions' (and the fp32 step, which sets each leaf's tolerance) on the
    batch the recipe's first step of that kind took; frozen parameters the
    same bits; the ms of each kernel-route step (warm: the recipe ran these
    shapes)."""
    step_ms = {}
    for kind in ("stage1", "stage2", "stage3_even", "stage3_odd"):
        batch = probe.first_batch[kind]
        loss_k, g_k, n_k, before, after, step_ms[kind] = bf16_first_step(kind, batch, "kernel")
        loss_p, g_p, n_p, _, _, _ = bf16_first_step(kind, batch, "plain")
        loss_32, g_32, _, _, _, _ = bf16_first_step(kind, batch, "fp32")
        gaps, bf16_gaps = leaf_gaps(g_k, g_p), leaf_gaps(g_p, g_32)
        floor = lambda k: BF16_SCALAR_GRAD_FLOOR if g_p[k].numel() == 1 else BF16_GRAD_FLOOR
        over = [k for k, g in gaps.items() if g > max(floor(k), 2 * bf16_gaps[k])]
        worst = max(gaps, key=gaps.get)
        rel = abs(loss_k - loss_p) / abs(loss_p)
        want = expected_launches(kind, len(batch[0]), torch.bfloat16, False, "cmajor")
        ok = (np.isfinite(loss_k) and rel <= BF16_LOSS_RTOL and not over and n_k == want and n_p == [0, 0, 0]
              and g_k.keys() == g_p.keys())
        print(f"  {kind:11s} bf16 first step: loss {loss_k:.6f} vs plain {loss_p:.6f} (rel {rel:.1e}, tol "
              f"{BF16_LOSS_RTOL:.0e}; fp32 {loss_32:.6f}); {len(g_k)} gradients, worst {gaps[worst]:.2e} of its max "
              f"({worst}; bf16 against fp32 there {bf16_gaps[worst]:.2e}, worst anywhere "
              f"{max(bf16_gaps.values()):.2e}); {len(over)} leaves over their tolerance; launches {n_k} (gate: "
              f"{want}), plain {n_p}; {step_ms[kind]:.1f} ms {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"{kind}: the bf16 step through the kernels disagrees with the plain route: {over[:5]}")
        check_frozen(kind if kind in ("stage1", "stage2") else "stage3", before, after, g_k)


def recipes_phase():
    """The user's recipes at the published width and full geometry; returns
    the launches of the quality run, this phase's main path."""
    from swinwnet_tpu_torch.recipes import classical_baselines, quality_continue, quality_run, rl_run, train_synthetic

    t_phase = time.perf_counter()
    rounded = lambda d, n=1: {k: [round(t, n) for t in v] if isinstance(v, list) else round(v, n) for k, v in d.items()}
    with tempfile.TemporaryDirectory() as tmp:
        q = os.path.join(tmp, "Q")
        probe = StepProbe()
        sb.reset_counts()
        t0 = time.perf_counter()
        with probe.installed():
            summary, seconds = quality_run.main([*QUALITY_FLAGS, "--out", q])
        torch.cuda.synchronize()
        quality_s, total = time.perf_counter() - t0, launches()
        step_ms, peak = probe.check("quality_run", ("stage1", "stage2", "stage3_even", "stage3_odd"))
        if list(summary) != summary_keys("quality_run"):
            raise SystemExit(f"quality_run: summary keys {list(summary)}")
        for kind in ("segmentation", "upscaling", "physical"):
            if key_tree(read_json(f"{q}_{kind}_metrics.json")) != key_tree(read_json(f"QUALITY_r05_{kind}_metrics.json")):
                raise SystemExit(f"quality_run: {kind} metrics' keys differ from QUALITY_r05's")
        if os.listdir(f"{q}_ckpt") != ["step_00000000.pt"]:
            raise SystemExit("quality_run: no checkpoint")
        gate = {k: expected_launches(k, RECIPE_B, torch.bfloat16, False, "cmajor") for k in step_ms}
        serving = [(round(t, 1), n[0]) for t, n, _, _ in probe.serving]
        print(f"  quality_run: {quality_s:.1f} s ({', '.join(f'{k} {v:.1f} s' for k, v in seconds.items())}); bf16 "
              f"steps at B={RECIPE_B}, ms {rounded(step_ms)}, launches per step as the gate's {gate}; peak memory of "
              f"a step, GiB {rounded(peak, 2)}; fp32 eval serving calls (ms, cst launches) {serving}; launches in the "
              f"run {total}")
        print(f"    step losses finite {[round(v, 4) for v in probe.losses]}; HR IoU@0.50 "
              f"{summary['segmentation']['High Res']['0.50 thrashold']['IoU'][0]:.4f}, PSNR "
              f"{summary['upscaling']['Summary Metrics']['PSNR'][0]:.2f} dB; files "
              f"{sorted(os.path.basename(p) for p in os.listdir(tmp))}")

        print("  the first bf16 step of each stage, kernels against their plain versions")
        compare_bf16_first_steps(probe)

        probe = StepProbe()
        t0 = time.perf_counter()
        with probe.installed():
            cont = quality_continue.main(["--ckpt", f"{q}_ckpt", "--out", q, *RECIPE_DATA, "--sr-epochs", "1",
                                          "--full-epochs", "1", "--fused-blocks"])
        cont_s = time.perf_counter() - t0
        step_ms, peak = probe.check("quality_continue", ("stage2", "stage3_even", "stage3_odd"))
        if list(cont) != summary_keys("quality_continue") or not os.path.isdir(f"{q}_ckpt_cont"):
            raise SystemExit("quality_continue: keys or checkpoint")
        print(f"  quality_continue: {cont_s:.1f} s; bf16 steps at B={RECIPE_B} (the shapes warm from quality_run), "
              f"ms {rounded(step_ms)}, at the gate's launches; peak memory of a step, GiB {rounded(peak, 2)}")

        probe = StepProbe()
        t0 = time.perf_counter()
        with probe.installed():
            rl = rl_run.main(["--ckpt", f"{q}_ckpt", "--out", os.path.join(tmp, "R"), *RECIPE_DATA, "--epochs", "1",
                              "--ablation-gains", "0.5", "--fused-blocks"])
        rl_s = time.perf_counter() - t0
        step_ms, _ = probe.check("rl_run", ("rl",))
        if list(rl) != summary_keys("rl_run") or not all(np.isfinite(v) for v in rl["reward_curve"]):
            raise SystemExit("rl_run: keys or reward")
        print(f"  rl_run: {rl_s:.1f} s; RL steps {rounded(step_ms)['rl']} ms at "
              f"{expected_launches('rl', RECIPE_B, torch.bfloat16, False, 'cmajor')} launches (the gate's count); "
              f"reward {rl['reward_curve']}, gain {rl['alpha']['gain_mean']:.4f}")

        for mask in ("gt", "ckpt"):
            t0 = time.perf_counter()
            c = classical_baselines.main(["--data", "synthetic", "--eval-renders-per-crystal", "1", "--noise-passes",
                                          "1", "--mask", mask, "--ckpt", f"{q}_ckpt", "--fused-blocks",
                                          "--out", os.path.join(tmp, f"C{mask}")])
            if list(c) != summary_keys("classical_baselines") or c["n_samples"] != 6:
                raise SystemExit(f"classical_baselines --mask {mask}: keys or samples")
            print(f"  classical_baselines --mask {mask}: {time.perf_counter() - t0:.1f} s; bilinear Peak Intensity "
                  f"{c['baselines']['bilinear']['Peak Intensity'][0]:.4f}")

        t0 = time.perf_counter()
        syn = os.path.join(tmp, "syn")
        train_synthetic.main(["--samples", "8", "--epochs", "1", "--rl-epochs", "1", "--out", syn])
        # the plot needs matplotlib, which a machine may not have
        plot = ["physical_metrics.png"] if importlib.util.find_spec("matplotlib") else []
        if sorted(os.listdir(syn)) != sorted(["checkpoints", "physycal_metrics.json", "segmentation_metrics.json",
                                              "upscaling_metrics.json", *plot]):
            raise SystemExit(f"train_synthetic wrote {sorted(os.listdir(syn))}")
        print(f"  train_synthetic: {time.perf_counter() - t0:.1f} s, files {sorted(os.listdir(syn))}")
    print(f"  phase [19] {time.perf_counter() - t_phase:.1f} s")
    return total


# ---------------------------------------------------------------------------
# [20] entry()
# ---------------------------------------------------------------------------


def entry_check():
    """entry() on the card: fn(model, x) is [1, 2, 500, 960], finite, and
    the same weights through the fused kernels' route (every level the gate
    admits) agree with it at PIPE_TOL fp32. Returns (ms a call, launches)."""
    from swinwnet_tpu_torch.entry import entry

    fn, (model, x) = entry()
    fn(model, x)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn(model, x)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    ok = tuple(out.shape) == (1, 2, 2 * H, 2 * W) and bool(torch.isfinite(out).all())
    print(f"  entry(): fn(model, x) {tuple(out.shape)}, finite {ok}, {ms:.1f} ms (every level unfused, fp32, "
          f"as the JAX entry)")
    if not ok:
        raise SystemExit("entry(): wrong shape or non-finite output")
    levels = [m for m in model.modules() if isinstance(m, BasicLayer)]
    for m in levels:
        m.fused_blocks = True
    sb.reset_counts()
    try:
        fused = fn(model, x)
        torch.cuda.synchronize()
    finally:
        for m in levels:
            m.fused_blocks = False
    n = launches()
    want = expected_launches("serve", 1, torch.float32, False, "cmajor")
    if n != want:
        raise SystemExit(f"entry(): the fused route launched {n} (gate: {want})")
    pipe_compare("entry() images_masked_hr, the 10 cst launches (kernel) against every level unfused (plain):",
                 fused, out, torch.float32, relative=True)
    return ms, n


def plan_text(C, nH, dtype, round_qkv=True):
    """A launch's plan, which body it takes, its registers and CTAs an SM."""
    p = sb.kernel_plan(C, nH, dtype, round_qkv)
    regs, ctas = sb.kernel_info(C, nH, dtype, round_qkv)
    if p.body == 2:
        return (f"narrow body: {p.WB} window(s) a warp, {p.threads // 32} warps a CTA, head width {p.CN} padded "
                f"to {p.ldq}, {p.smem_bytes} B shared, {regs} registers, {ctas} CTAs an SM (planned {p.min_ctas})")
    if p.body == 1:
        weights = f"a ring of {p.ring} weight slots" if p.ring else "weights resident"
        return (f"Hopper body: WB={p.WB} G={p.G}{'x3 parts' if p.parts == 3 else ''} HC={p.HC} {p.mp} rows padded, "
                f"{p.nwg} consumer warpgroups + a window and a weight producer warp, {weights}, swizzle spans "
                f"{p.spans[:2]}, {p.smem_bytes} B shared, {regs} registers, {ctas} CTAs an SM (planned {p.min_ctas})")
    return (f"fp32-FMA body: WB={p.WB} G={p.G} HC={p.HC} tile {p.KC}x{p.OT} 5x{p.CN} a thread, {p.smem_bytes} B "
            f"shared, {regs} registers, {ctas} CTAs an SM")


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


# ---------------------------------------------------------------------------
# [22] The compiled programs
# ---------------------------------------------------------------------------

# the training comparisons' schedule: two steps an epoch, two warm-up
# epochs, so the learning rate doubles between steps 2 and 3
PROGRAM_SCHEDULE = dict(base_lr=1e-3, warmup_epochs=2, num_epochs=4, steps_per_epoch=2)
PROGRAM_STEPS = 4
FLAGSHIP_B = 64  # the flagship serving batch: make_inference_fn, RL serving and the mesh's batch a card
UNFUSED_B = 8  # the unfused fp32 serving program's batch
PROGRAM_BITS = {}  # check -> whether every comparison in it had the same bits


def hold_stages(tag, got, want, dtype):
    """`got` against `want` stage by stage: the same bits, or (where cuBLAS
    took another algorithm under capture) PIPE_TOL of each stage's scale
    (1 for probabilities and alpha, else max|want|). Returns whether every
    stage had the same bits."""
    differ = [k for k in want if not torch.equal(got[k], want[k])]
    tol_max, tol_mean = PIPE_TOL[dtype]
    for k in differ:
        a, b = got[k].float(), want[k].float()
        scale = 1.0 if k.startswith("seg") or k == "alpha" else max(b.abs().max().item(), 1e-30)
        err, mean = (a - b).abs().max().item(), (a - b).abs().mean().item()
        ok = bool(torch.isfinite(a).all()) and err <= tol_max * scale and mean <= tol_mean * scale
        print(f"    {tag} {k}: not the same bits, max_abs={err:.3e} (tol {tol_max * scale:.3e}) mean_abs={mean:.3e} "
              f"(tol {tol_mean * scale:.3e}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"[22] {tag}: the program's {k} disagrees with the eager pipeline")
    return not differ


def eagerly(fn):
    """`fn` with every program in it run eagerly."""
    def call(*args):
        with graphs.run_eagerly():
            return fn(*args)
    return call


def serving_program(tag, dtype, fn, eager, n_signatures, want, rng, other_state, model, names=STAGE_NAMES):
    """A serving program `fn` against `eager` (the same pipeline, the same
    model, run eagerly): its replays give the eager result of their input
    (the same bits, else PIPE_TOL), launch `want` a replay, leave an earlier
    call's tensors as they were; a new batch size captures a new graph;
    `load_state_dict(other_state)` changes the weights with no new graph and
    a replaced Parameter with one. Returns the launches of the run."""
    draw = lambda b: torch.from_numpy(rng.uniform(0, 1e3, (b, 2, H, W)).astype(np.float32)).cuda()
    x1, x2 = draw(B), draw(B)
    take = lambda d: {k: d[k].detach().clone() for k in names}
    start, bits = launches(), []
    e1 = take(eager(x1))
    bits.append(hold_stages(f"{tag} first call", fn(x1), e1, dtype))
    before = launches()
    out1 = fn(x1)
    torch.cuda.synchronize()
    n = [b - a for a, b in zip(before, launches())]
    bits.append(hold_stages(f"{tag} replay", out1, e1, dtype))
    kept = take(out1)
    bits.append(hold_stages(f"{tag} another input", fn(x2), take(eager(x2)), dtype))
    intact = all(torch.equal(out1[k], kept[k]) for k in names)
    graphs = [n_signatures()]
    fn(x1[:1])
    bits.append(hold_stages(f"{tag} B=1", fn(x1[:1]), take(eager(x1[:1])), dtype))
    graphs.append(n_signatures())
    model.load_state_dict(other_state)
    out_w = fn(x1)
    graphs.append(n_signatures())
    e_w = take(eager(x1))
    moved = not torch.equal(e_w[names[-1]], e1[names[-1]])
    bits.append(hold_stages(f"{tag} other weights", out_w, e_w, dtype))
    proj = model.patch_embed.proj
    proj.weight = torch.nn.Parameter(proj.weight.detach() * 1.5)
    bits.append(hold_stages(f"{tag} a replaced Parameter", fn(x1), take(eager(x1)), dtype))
    graphs.append(n_signatures())
    ok = n == want and intact and moved and graphs == [1, 2, 2, 3]
    PROGRAM_BITS[tag] = all(bits)
    print(f"  {tag}: launches a replay {n} (gate: {want}); replays against eager: "
          f"{'the same bits' if all(bits) else 'within PIPE_TOL, not all the same bits'}; the first call's tensors "
          f"intact after the second: {intact}; signatures captured after B={B}, B=1, load_state_dict, a replaced "
          f"Parameter: {graphs} (want [1, 2, 2, 3]); the other weights moved the output: {moved} "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"[22] {tag}: a check of the program failed")
    return [b - a for a, b in zip(start, launches())]


def serving_programs(rng):
    """[22]'s serving checks; returns the launches."""
    from swinwnet_tpu_torch.pipelines.split import inference_stages

    total = [0, 0, 0]
    for tag, dtype, kw in (("serving bf16", torch.bfloat16, {}), ("serving fp32", torch.float32, {}),
                           ("serving bf16 nmajor", torch.bfloat16, {"fused_layout": "nmajor"})):
        model = build_model(dtype, **kw).eval()
        fn = make_inference_fn(model)
        eager = lambda x, m=model: inference_stages(m, x)
        want = expected_launches("serve", B, dtype, False, kw.get("fused_layout", "cmajor"))
        other = build_model(dtype, seed=SEED + 11, **kw).state_dict()
        total = add(total, serving_program(tag, dtype, fn, eager, lambda: fn.num_graphs, want, rng, other, model))
        if tag == "serving bf16":
            total = add(total, serving_at(tag, dtype, fn, eager, FLAGSHIP_B,
                                          expected_launches("serve", FLAGSHIP_B, dtype, False, "cmajor"), rng))
        del model, fn, other

    # the split route: its three programs against eager, and against the single route bit for bit
    model = build_model(torch.bfloat16).eval()
    split = make_split_inference_fn(model)
    n_sig = lambda: max(p.num_graphs for p in (split.stage_a, split.stage_b, split.stage_c))
    want = expected_launches("serve", B, torch.bfloat16, False, "cmajor")
    other = build_model(torch.bfloat16, seed=SEED + 11).state_dict()
    total = add(total, serving_program("split bf16", torch.bfloat16, split, lambda x, m=model: inference_stages(m, x),
                                       n_sig, want, rng, other, model))
    x = torch.from_numpy(rng.uniform(0, 1e3, (B, 2, H, W)).astype(np.float32)).cuda()
    single = make_inference_fn(model)
    n0 = launches()
    got, want_stages = split(x), single(x)
    got, want_stages = split(x), single(x)
    same = [k for k in STAGE_NAMES if torch.equal(got[k], want_stages[k])]
    seg_only = torch.equal(split.stage_a(x)[1], want_stages["seg_map_lr"])
    print(f"  split route: the three programs' replays equal the single program's bit for bit in "
          f"{len(same)}/{len(STAGE_NAMES)} stages; stage_a alone gives seg_map_lr bit for bit: {seg_only} "
          f"{'ok' if len(same) == len(STAGE_NAMES) and seg_only else 'FAIL'}")
    if len(same) < len(STAGE_NAMES) or not seg_only:
        raise SystemExit("[22] the split programs do not equal the single program bit for bit")
    total = add(total, [b - a for a, b in zip(n0, launches())])
    del model, split, single, other, got, want_stages

    # RL serving
    model, policy = build_model(torch.bfloat16).eval(), rl_policy()
    fn = make_rl_inference_fn(model, policy)
    eager = lambda x: rl_inference_stages(model, policy, x)
    other = build_model(torch.bfloat16, seed=SEED + 11).state_dict()
    total = add(total, serving_program("RL serving bf16", torch.bfloat16, fn, eager, lambda: fn.num_graphs, want,
                                       rng, other, model, names=STAGE_NAMES + ("alpha",)))
    total = add(total, serving_at("RL serving bf16", torch.bfloat16, fn, eager, FLAGSHIP_B,
                                  expected_launches("serve", FLAGSHIP_B, torch.bfloat16, False, "cmajor"), rng,
                                  names=STAGE_NAMES + ("alpha",)))
    del model, policy, fn, other

    # fp32 with every level unfused (the expansions still their kernel): no Swin-block launch
    model = build_model(torch.float32).eval()
    for m in model.modules():
        if isinstance(m, BasicLayer):
            m.fused_blocks = False
    fn = make_inference_fn(model)
    total = add(total, serving_at("serving fp32 unfused", torch.float32, fn, lambda x: inference_stages(model, x),
                                  UNFUSED_B, [0, 0, 0], rng))
    del model, fn
    return add(total, mesh_serving())


def serving_at(tag, dtype, fn, eager, batch, want, rng, names=STAGE_NAMES):
    """A serving program `fn` at one more batch size: its first call (the
    capture) and a replay against `eager` on the same input (the same bits,
    else PIPE_TOL), `want` launches a replay. Returns the launches of the
    run."""
    x = torch.from_numpy(rng.uniform(0, 1e3, (batch, 2, H, W)).astype(np.float32)).cuda()
    take = lambda d: {k: d[k].detach().clone() for k in names}
    start = launches()
    e = take(eager(x))
    bits = [hold_stages(f"{tag} B={batch} first call", fn(x), e, dtype)]
    before = launches()
    out = fn(x)
    torch.cuda.synchronize()
    n = [b - a for a, b in zip(before, launches())]
    bits.append(hold_stages(f"{tag} B={batch} replay", out, e, dtype))
    PROGRAM_BITS[f"{tag} B={batch}"] = all(bits)
    print(f"  {tag} B={batch}: launches a replay {n} (gate: {want}); the capture and the replay against eager: "
          f"{'the same bits' if all(bits) else 'within PIPE_TOL, not all the same bits'} {'ok' if n == want else 'FAIL'}")
    if n != want:
        raise SystemExit(f"[22] {tag} B={batch}: a replay launched {n}, the gate {want}")
    return [b - a for a, b in zip(start, launches())]


def mesh_rank(rank, n, port, out_path):
    """One rank of [22]'s serving on the data mesh: the bf16 model drawn
    from its own seed, then replicated from rank 0, must hold rank 0's
    weights; its FLAGSHIP_B images of a global batch through
    make_inference_fn, captured and replayed against the same pipeline run
    eagerly. Rank 0 writes its launches a replay, of the rank's run, and
    whether its replay had the eager bits."""
    from swinwnet_tpu_torch.parallel import initialize_multihost, make_mesh, replicate, shard_batch
    from swinwnet_tpu_torch.pipelines.split import inference_stages

    initialize_multihost(f"localhost:{port}", n, rank, device="cuda")
    try:
        mesh = make_mesh(n)
        start = launches()
        model = replicate(build_model(torch.bfloat16, seed=SEED + rank), mesh).eval()
        ref = build_model(torch.bfloat16).state_dict()
        if not all(torch.equal(v, ref[k]) for k, v in model.state_dict().items()):
            raise SystemExit(f"[22] mesh rank {rank}: the replicated weights are not rank 0's")
        global_batch = np.random.default_rng(SEED).uniform(0, 1e3, (FLAGSHIP_B * n, 2, H, W)).astype(np.float32)
        x = shard_batch(global_batch, mesh)
        fn = make_inference_fn(model)
        want = {k: v.detach().clone() for k, v in inference_stages(model, x).items() if k in STAGE_NAMES}
        fn(x)
        before = launches()
        out = fn(x)
        torch.cuda.synchronize()
        per_replay = [b - a for a, b in zip(before, launches())]
        bits = hold_stages(f"mesh rank {rank} replay", out, want, torch.bfloat16)
        if rank == 0:
            torch.save({"replay": per_replay, "run": [b - a for a, b in zip(start, launches())], "bits": bits},
                       out_path)
    finally:
        torch.distributed.destroy_process_group()


def mesh_serving():
    """make_inference_fn on the data mesh over every card (mesh_rank a
    card, NCCL): rank 0's launches a replay against the gate. Returns rank
    0's launches."""
    n = torch.cuda.device_count()
    torch.cuda.empty_cache()  # the ranks' processes share the card with this one
    with tempfile.TemporaryDirectory() as tmp:
        out_path = os.path.join(tmp, "rank0.pt")
        torch.multiprocessing.spawn(mesh_rank, args=(n, dryrun_mod.free_port(), out_path), nprocs=n, join=True)
        out = torch.load(out_path)
    want = expected_launches("serve", FLAGSHIP_B, torch.bfloat16, False, "cmajor")
    PROGRAM_BITS[f"serving bf16 on the mesh of {n}"] = out["bits"]
    ok = out["replay"] == want
    print(f"  serving bf16 on the data mesh of {n} card(s), B={FLAGSHIP_B} a card: replicated weights rank 0's; "
          f"rank 0's launches a replay {out['replay']} (gate: {want}); its replay against eager: "
          f"{'the same bits' if out['bits'] else 'within PIPE_TOL, not the same bits'} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"[22] serving on the mesh: a replay launched {out['replay']}, the gate {want}")
    return out["run"]


def step_of(kind, model, tx, compute_dtype, sr_loss):
    """The factories' step of `kind`; returns (step, how to read its loss)."""
    if kind == "stage1":
        return make_stage1_step(model, tx, combined_loss, compute_dtype), lambda out: out
    if kind == "stage2":
        return make_stage2_step(model, tx, sr_loss, compute_dtype), lambda out: out
    even, odd, _, _ = make_stage3_steps(model, tx, combined_loss, sr_loss, compute_dtype=compute_dtype)
    return (even if kind == "stage3_even" else odd), lambda out: out["loss"]


def program_steps(kind, batches, model_kw, compute_dtype, sr_loss, eager, constant_lr=False):
    """PROGRAM_STEPS steps of `kind` from the seed's weights on `batches`
    through the factories (eagerly when `eager`), at PROGRAM_SCHEDULE or
    held at its epoch-0 rate. Returns (model, the parameters before, losses,
    launches per step)."""
    model = build_model(torch.float32, **model_kw).train()
    schedule = warmup_cosine_schedule(**PROGRAM_SCHEDULE)
    lr = (lambda count: schedule(count * 0)) if constant_lr else schedule
    tx = masked_adamw(model, kind if kind in ("stage1", "stage2") else "stage3", lr)
    state = TrainState.create(model, tx)
    step, loss_of = step_of(kind, model, tx, compute_dtype, sr_loss)
    before, losses, counts = snapshot(model), [], []
    with graphs.run_eagerly() if eager else contextlib.nullcontext():
        for images, masks in batches:
            n0 = launches()
            state, out = step(state, images, masks)
            losses.append(float(loss_of(out)))
            counts.append([b - a for a, b in zip(n0, launches())])
    return model, before, losses, counts


def agree(got, want, before):
    """Leaves after the steps: (the leaves whose bits differ, the worst
    leaf's |got - want| over its largest change in the steps)."""
    differ = [k for k in want if not torch.equal(got[k], want[k])]
    worst = 0.0
    for k in differ:
        moved = (want[k] - before[k]).abs().max().item()
        worst = max(worst, (got[k] - want[k]).abs().max().item() / max(moved, 1e-30))
    return differ, worst


def training_program(kind, dtype, batch, model_kw, rng):
    """PROGRAM_STEPS captured steps against as many eager ones from the same
    weights and batches, the learning rate doubling between steps 2 and 3:
    each step's loss and every leaf after the last (the same bits, else
    TRAIN_LOSS_RTOL and TRAIN_GRAD_TOL of each leaf's change), frozen leaves
    the same bits, launches a step; the control, the same captured steps at
    epoch 0's rate throughout, must agree up to step 3's loss and fail
    after. Returns the launches."""
    compute_dtype = None if dtype == torch.float32 else "bfloat16"
    sr_loss = smooth_l1_loss if dtype == torch.float32 else smooth_l1_ssim_loss
    fused_deep = model_kw.get("fused_deep", False)
    want = expected_launches(kind, batch, dtype, fused_deep, "cmajor")
    batches = [(torch.from_numpy(i).cuda(), torch.from_numpy(m).cuda())
               for i, m in training_batches(PROGRAM_STEPS, batch, rng)]
    start = launches()
    eager_model, before, e_losses, _ = program_steps(kind, batches, model_kw, compute_dtype, sr_loss, eager=True)
    e_after = snapshot(eager_model)
    model, before_p, p_losses, counts = program_steps(kind, batches, model_kw, compute_dtype, sr_loss, eager=False)
    after = snapshot(model)
    close = lambda a, b: a == b or abs(a - b) <= TRAIN_LOSS_RTOL * abs(b)
    differ, worst = agree(after, e_after, before)
    stage = kind if kind in ("stage1", "stage2") else "stage3"
    frozen = [k for k in before if not STAGE_TRAINS[stage](k.split(".")[0])]
    frozen_same = all(torch.equal(after[k], before[k]) for k in frozen)
    same_losses = p_losses == e_losses
    ok = (all(map(close, p_losses, e_losses)) and worst <= TRAIN_GRAD_TOL and frozen_same
          and all(n == want for n in counts) and all(torch.equal(before_p[k], before[k]) for k in before))
    bits = same_losses and not differ
    PROGRAM_BITS[f"{kind} {str(dtype)[6:]}"] = bits
    tag = f"{kind:11s} {str(dtype)[6:]:8s} B={batch}"
    print(f"  {tag}: losses captured {[f'{v:.7g}' for v in p_losses]} eager {[f'{v:.7g}' for v in e_losses]}; "
          f"after {PROGRAM_STEPS} steps {len(after) - len(differ)}/{len(after)} leaves the same bits"
          + (f" (worst {worst:.2e} of its change, tol {TRAIN_GRAD_TOL:.0e})" if differ else "")
          + f"; {len(frozen)} frozen leaves the same bits: {frozen_same}; launches a step {counts} (gate: {want}) "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"[22] {kind} {dtype}: the captured steps disagree with the eager steps")
    del model, eager_model

    c_model, _, c_losses, _ = program_steps(kind, batches, model_kw, compute_dtype, sr_loss, eager=False,
                                            constant_lr=True)
    c_differ, c_worst = agree(snapshot(c_model), e_after, before)
    held = all(map(close, c_losses[:3], e_losses[:3]))
    caught = not close(c_losses[3], e_losses[3]) or c_worst > TRAIN_GRAD_TOL
    print(f"    control, the rate held at epoch 0's: losses {[f'{v:.7g}' for v in c_losses]}; steps 1-3 agree: "
          f"{held}; step 4's loss or the leaves fail the comparison: {caught} (worst leaf {c_worst:.2e} of its "
          f"change) {'ok' if held and caught else 'FAIL'}")
    if not (held and caught):
        raise SystemExit(f"[22] {kind} {dtype}: the control with a stale learning rate was not caught")
    del c_model
    torch.cuda.empty_cache()
    return [b - a for a, b in zip(start, launches())]


RL_DISTANCE = 10  # the reward's distance gate (diffraction_metrics_device's default)


def rl_leaves(model, policy):
    out = snapshot(model)
    out.update({f"policy.{k}": p.detach().clone() for k, p in policy.named_parameters()})
    return out


@contextlib.contextmanager
def counting_gate(counts, spectra=None):
    """Note each distance-gate call's largest count of candidates in a
    spectrum (a host read: eager runs only), and its inputs in `spectra`."""
    enforce = peaks_mod._enforce_distance

    def gate(mask, I, distance):
        counts.append(int(mask.sum(1).max()))
        if spectra is not None:
            spectra[:] = [mask.clone(), I.clone()]
        return enforce(mask, I, distance)

    peaks_mod._enforce_distance = gate
    try:
        yield
    finally:
        peaks_mod._enforce_distance = enforce


@contextlib.contextmanager
def gate_bound(bound):
    """The distance gate's static loop count set to `bound` (None: as it is)."""
    orig = peaks_mod.max_candidates
    if bound is not None:
        peaks_mod.max_candidates = lambda n: bound
    try:
        yield
    finally:
        peaks_mod.max_candidates = orig


def rl_candidates(images, noise):
    """The most candidates the reward's gate sees in a spectrum on `images`
    with `noise`, for rl_model's weights in bf16 (eager, no update)."""
    model, policy, counts = rl_model(), rl_policy(), []
    with torch.no_grad(), compute_dtype_of(model, torch.bfloat16), counting_gate(counts):
        seg_images, norm_lr, _, params_hr, skips = rl_mod.rl_preprocess(model, images)
        mu, std = policy(norm_lr)
        rl_mod.rl_reward(model, Qwrapper(fixed_centers=d_centers_hr), norm_lr, skips, mu + std * noise, params_hr,
                         seg_images, 2.0, 1.0, 0.5)
    del model, policy
    return counts[0]


def rl_steps(batches, eager, bound=None, counts=None, spectra=None):
    """One bf16 RL step a batch from rl_model's weights, noise drawn from a
    generator seeded SEED on the card: through make_rl_train_step's program,
    or (`eager`) rl_step itself on the same draws. `bound` patches the
    distance gate's loop count while the program captures; `counts` and
    `spectra` note the gate's calls (eager only). Returns (metrics a step,
    leaves before, leaves after, launches a step, peak GiB above what was
    allocated before the first step (the program's graph pool included))."""
    model, policy = rl_model(), rl_policy()
    model_tx = masked_adamw(model, "rl", 1e-5, weight_decay=0.0)
    policy_tx = AdamW(policy.parameters(), 1e-4, weight_decay=0.0)
    qw = Qwrapper(fixed_centers=d_centers_hr)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    state = RLState(TrainState.create(model, model_tx), TrainState.create(policy, policy_tx), gen)
    step = make_rl_train_step(model, policy, model_tx, policy_tx, qw, compute_dtype="bfloat16")

    def eager_step(images):
        noise = torch.randn((images.shape[0], 1), generator=gen, device="cuda")
        with compute_dtype_of(model, torch.bfloat16):
            return rl_step(model, policy, model_tx, policy_tx, qw, images, noise)

    before, metrics, per_step = rl_leaves(model, policy), [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()  # the weights and what earlier phases hold
    noting = counting_gate(counts, spectra) if counts is not None else contextlib.nullcontext()
    with gate_bound(bound), noting:
        for images in batches:
            n0 = launches()
            m = eager_step(images) if eager else step(state, images)[1]
            metrics.append({k: float(v) for k, v in m.items()})
            per_step.append([b - a for a, b in zip(n0, launches())])
    peak_gb = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    return metrics, before, rl_leaves(model, policy), per_step, peak_gb


def rl_agree(got, want, before):
    """RL steps against RL steps: (the same bits in every metric and leaf,
    within [8]'s limits: each metric to TRAIN_LOSS_RTOL, each leaf to
    TRAIN_GRAD_TOL of its largest change)."""
    (m_g, after_g), (m_w, after_w) = got, want
    differ, worst = agree(after_g, after_w, before)
    close = all(a[k] == b[k] or abs(a[k] - b[k]) <= TRAIN_LOSS_RTOL * abs(b[k]) for a, b in zip(m_g, m_w) for k in b)
    return m_g == m_w and not differ, close and worst <= TRAIN_GRAD_TOL


def rl_program(rng, lines):
    """[22]'s RL step: four captured bf16 steps at [RL_B, 2, 250, 480]
    against four eager rl_steps from the same weights and noise (the same
    bits, else [8]'s limits), frozen leaves, launches a step (the narrow
    body's too), peak memory; the gate alone captured against its warm-up;
    a capture on a batch with few distance-gate candidates replayed on one
    with more against eager on the same two batches, and the control with
    the gate's bound frozen at the first batch's count, which must fail.
    Returns the launches of the checked runs."""
    start = launches()
    want = expected_launches("rl", RL_B, torch.bfloat16, False, "cmajor")
    # the SR head's levels (C <= 24) take the narrow body in both half-size upscales
    want_narrow = sum(r[4] for r in RL_LEVELS if r[1] <= sb.NARROW_MAX_C)
    batches = [torch.from_numpy(bragg_patterns(rng, RL_B, lines)).cuda() for _ in range(PROGRAM_STEPS)]
    counts, spectra = [], []
    e_metrics, before, e_after, _, e_peak = rl_steps(batches, eager=True, counts=counts, spectra=spectra)
    n0 = sb.NARROW_LAUNCHES.launches
    p_metrics, before_p, p_after, per_step, p_peak = rl_steps(batches, eager=False)
    narrow = (sb.NARROW_LAUNCHES.launches - n0) / PROGRAM_STEPS
    bits, close = rl_agree((p_metrics, p_after), (e_metrics, e_after), before)
    model_leaves = lambda d: {k: v for k, v in d.items() if not k.startswith("policy.")}
    frozen = [k for k in model_leaves(before) if not STAGE_TRAINS["rl"](k.split(".")[0])]
    frozen_same = all(torch.equal(p_after[k], before[k]) for k in frozen)
    policy_moved = all(not torch.equal(p_after[k], before[k]) for k in before if k.startswith("policy."))
    rewards = [m["reward"] for m in p_metrics]
    ok = (close and frozen_same and policy_moved and all(n == want for n in per_step) and narrow == want_narrow
          and 0.0 not in rewards)
    PROGRAM_BITS["RL step bf16"] = bits
    e_rewards = [f"{m['reward']:.7g}" for m in e_metrics]
    print(f"  RL step bf16 B={RL_B}: {PROGRAM_STEPS} captured steps against as many eager rl_steps: rewards "
          f"{[f'{r:.7g}' for r in rewards]} eager {e_rewards}; every metric and "
          f"{len(before)} model and policy leaves: {'the same bits' if bits else 'within [8] limits, not the same bits'}; "
          f"{len(frozen)} frozen leaves the same bits: {frozen_same}; launches a step {per_step} (gate: {want}), "
          f"of them the narrow body's {narrow:g} ({want_narrow} expected); the gate's candidates a step {counts} of {peaks_mod.max_candidates(len(d_centers_hr))} ranks; peak "
          f"device memory above the start {p_peak:.2f} GiB (eager {e_peak:.2f}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("[22] RL: the captured steps disagree with the eager rl_steps")
    mask, I = spectra
    gate = graphs.Program(lambda m, i: peaks_mod._enforce_distance(m, i, RL_DISTANCE))
    if not torch.equal(gate(mask, I), gate(mask, I)):
        raise SystemExit("[22] RL: the captured distance gate differs from its warm-up")
    del gate

    # capture on a batch with few candidates, replay on one with more
    noises = torch.randn((2, RL_B, 1), generator=torch.Generator(device="cuda").manual_seed(SEED), device="cuda")
    b = torch.from_numpy(bragg_patterns(rng, RL_B, lines)).cuda()
    raw = torch.from_numpy(bragg_patterns(rng, RL_B, lines)).cuda()
    c_b = rl_candidates(b, noises[1])
    for scale in (1e-3, 1e-4, 1e-5, 1e-6):
        a = raw * scale
        c_a = rl_candidates(a, noises[0])
        if 0 < c_a <= c_b // 2:
            break
    else:
        raise SystemExit(f"[22] RL: no scale of a batch gives fewer gate candidates than {c_b}")
    counts = []
    e_metrics, before, e_after, _, _ = rl_steps([a, b], eager=True, counts=counts)
    p_metrics, _, p_after, _, _ = rl_steps([a, b], eager=False)
    bits_ab, close_ab = rl_agree((p_metrics, p_after), (e_metrics, e_after), before)
    c_metrics, _, c_after, _, _ = rl_steps([a, b], eager=False, bound=counts[0])
    bits_c, close_c = rl_agree((c_metrics[1:], c_after), (e_metrics[1:], e_after), before)
    ok = counts[1] > counts[0] and close_ab and not close_c
    PROGRAM_BITS["RL capture on A, replay on B"] = bits_ab
    print(f"  RL capture on A (Bragg patterns x{scale:g}: {counts[0]} gate candidates in a spectrum at most), replay "
          f"on B ({counts[1]} candidates): against eager on A then B, "
          f"{'the same bits' if bits_ab else 'within [8] limits, not the same bits' if close_ab else 'FAIL'}; "
          f"reward on B {p_metrics[1]['reward']:.7g} eager {e_metrics[1]['reward']:.7g}; control, the gate's bound "
          f"frozen at A's {counts[0]}: reward on B {c_metrics[1]['reward']:.7g}, fails the comparison: "
          f"{not close_c} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("[22] RL: a replay on a batch with more gate candidates than its capture's is wrong, or the "
                         "frozen-bound control was not caught")
    torch.cuda.empty_cache()
    return [b_ - a_ for a_, b_ in zip(start, launches())]


def programs_phase(rng, lines):
    """[22]: serving, the RL step and training through the programs at the
    published width and full geometry. Returns the launches of the phase."""
    total = serving_programs(rng)
    total = add(total, rl_program(rng, lines))
    for kind in ("stage1", "stage2", "stage3_even", "stage3_odd"):
        total = add(total, training_program(kind, torch.float32, TRAIN_B, {"fused_deep": True}, rng))
    for kind in ("stage1", "stage2", "stage3_even", "stage3_odd"):
        total = add(total, training_program(kind, torch.bfloat16, RECIPE_B, {"remat": True, "attn_chunk": 8192},
                                            rng))
    print("  the same bits as eager in: " + ", ".join(f"{k} {v}" for k, v in PROGRAM_BITS.items()))
    return total


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
    # the flags are left as a user's process finds them: the port runs its
    # fp32 products at full fp32 itself (core.device.full_fp32)
    print(f"flags as found: torch.backends.cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}, "
          f"torch.backends.cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
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
    print(f"  patch_expand_norm: worst {check_expand_norm():.2f} bf16 ulp of its plain version over the ten shapes")
    print(f"  window_attention: worst {check_window_attention():.2f} of its rounding bound over the eight shapes")

    rng = np.random.default_rng(SEED)
    main_path = [0, 0, 0]  # launches per kernel over the main paths this script drives
    print(f"[3] serving, bf16, 3 requests of [{B}, 2, {H}, {W}]")
    stages, call_ms, per_call, total, plain, plain_ms = serve(bf16, B, 3, rng)
    print(f"  kernel launches per call [cst, row-major, wide] {per_call} (total {total})")
    want = expected_launches("serve", B, bf16, False, "cmajor")
    if want != [LAUNCHES_PER_CALL[bf16], 0, 0] or serve_attentions(B, bf16) != ATTENTIONS_PER_CALL:
        raise SystemExit(f"the gate's counts {want}, {serve_attentions(B, bf16)} are not LAUNCHES_PER_CALL, "
                         f"ATTENTIONS_PER_CALL")
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

    print("[9] fp32 at full fp32 under the flags as found, against float64")
    fp32_errs, fp32_control = check_fp32_precision()
    print(f"[10] the single-tower baselines, bf16: SwinUNet at [{SEG_B}, 2, {H}, {W}] through make_segmentation_fn, "
          f"SwinUNetSR at [{B}, 1, {H}, {W}] through make_sr_fn, 3 requests each")
    baselines = {}
    for kind in ("SwinUNet", "SwinUNetSR"):
        baselines[kind] = serve_baseline(kind, rng)
        main_path = add(main_path, baselines[kind][2])
    seg32_ms, total = seg_fp32_call(rng)
    main_path = add(main_path, total)
    print(f"[11] the split route: SwinWNetInference(split=True), bf16, 3 requests of [{B}, 2, {H}, {W}]")
    split_ms, single_ms, total = split_serve(rng)
    main_path = add(main_path, total)
    print(f"[12] the eval harness: MetricsCalculator over {HARNESS_N} synthesized patterns, batches of {B}")
    harness_ms, total = check_harness(rng)
    main_path = add(main_path, total)
    print(f"[13] the viewer CLI, fp32, {VIEW_B} synthesized patterns of [{H}, {W}], the published width")
    view_ms, view_session_ms, (view_load_ms, view_write_ms), view_cli_s, total = viewer_main_path(rng)
    main_path = add(main_path, total)
    print(f"[14] NativeBatcher feeding stage 1, fp32, fused_deep, {BATCHER_N} patterns in batches of {TRAIN_B}")
    b_build_s, b_step_ms, b_turns, b_ms, al_ms, total = batcher_main_path(rng)
    main_path = add(main_path, total)
    print("[15] the renderer's calibration with the rebin on the card and on the CPU")
    cal_ms = check_calibration()
    if min(main_path) == 0:
        raise SystemExit(f"a kernel was launched no time on the main paths: {main_path}")
    if expected_launches("rl", RL_B, bf16, False, "cmajor")[0] != (
            expected_launches("stage1", RL_B, bf16, False, "cmajor")[0] + sum(r[4] for r in RL_LEVELS)):
        raise SystemExit("RL_LEVELS are not the shapes of the RL step's upscale launches")

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"[16] times on {smi}")
    mean_ms = float(np.mean(call_ms))
    print(f"  serving bf16 B={B}: per call {', '.join(f'{t:.1f}' for t in call_ms)} ms (mean {mean_ms:.1f} ms, "
          f"{B / mean_ms * 1e3:.2f} images/s); through the plain versions {plain_ms:.1f} ms")
    print(f"  serving fp32 B=1: per call {', '.join(f'{t:.1f}' for t in ms32)} ms; through the plain versions {pms32:.1f} ms")
    print(f"  serving bf16 B={B} with fused_layout='nmajor': {ms_w[0]:.1f} ms; through the plain versions {pms_w:.1f} ms")
    for kind, ms in step_ms.items():
        warm = ms[1:] if len(ms) > 1 else ms
        print(f"  training fp32 B={TRAIN_B} {kind}: ms per step {[round(t, 1) for t in ms]}, "
              f"after the stage's first step {float(np.mean(warm)):.1f} ms")
    warm = lambda ts: float(np.mean(ts[1:]))
    print(f"  RL fine-tune bf16 B={RL_B}: ms per step {[round(t, 1) for t in rl_ms]}, after the first "
          f"{warm(rl_ms):.1f} ms; of which the reward (2 rebins + metrics) {warm(reward_ms):.2f} ms and the "
          f"distance gate {warm(gate_ms):.2f} ms ({peaks_mod.max_candidates(len(d_centers_hr))} ranks, {ranks} "
          f"candidates), eager ([22] has the program); peak device memory {rl_peak_gb:.2f} GiB")
    print(f"  RL serving bf16 B={RL_B}: per call {', '.join(f'{t:.1f}' for t in rl_call_ms)} ms (mean "
          f"{float(np.mean(rl_call_ms)):.1f} ms); through the plain versions {rl_plain_ms:.1f} ms")
    print("  physics alone: " + "; ".join(f"{k} {v:.4f} ms" for k, v in phys_ms.items()))
    for kind, (ms, p_ms, _, peak_gb, batch) in baselines.items():
        print(f"  {kind} bf16 B={batch}: per call {', '.join(f'{t:.1f}' for t in ms)} ms (mean {np.mean(ms):.1f} ms, "
              f"{batch / np.mean(ms) * 1e3:.1f} images/s); plain route {p_ms:.1f} ms; peak device memory "
              f"{peak_gb:.2f} GiB")
    print(f"  SwinUNet fp32 B={SEG_B}: one call {seg32_ms:.1f} ms")
    print(f"  split serving bf16 B={B}: per call {', '.join(f'{t:.1f}' for t in split_ms)} ms (mean "
          f"{np.mean(split_ms):.1f}); split=False in the same phase {np.mean(single_ms):.1f} ms")
    print("  eval harness bf16, notebook, AlphaPolicy, B=4: ms a sample " + ", ".join(
        f"{m} {t:.1f}" for m, t in harness_ms.items()))
    mean = lambda ts: float(np.mean(ts))
    print(f"  viewer CLI fp32 B={VIEW_B}: main() per call {', '.join(f'{t:.1f}' for t in view_ms)} ms (mean "
          f"{mean(view_ms):.1f} ms, {VIEW_B / mean(view_ms) * 1e3:.2f} images/s; of a call, load_model_any "
          f"{view_load_ms:.1f} ms and writing the 8 stages {view_write_ms:.1f} ms); "
          f"ViewerSession.run and the two rebins {', '.join(f'{t:.1f}' for t in view_session_ms)} ms (mean "
          f"{mean(view_session_ms):.1f} ms, {VIEW_B / mean(view_session_ms) * 1e3:.2f} images/s); the subprocess "
          f"{view_cli_s:.1f} s end to end")
    print(f"  NativeBatcher: g++ build {b_build_s:.2f} s; next() {mean(b_ms):.3f} ms a batch of [{TRAIN_B}, 1, {H}, "
          f"{W}] with the train noise (ArrayLoader with make_train_noise_augment {mean(al_ms):.3f} ms); stage-1 "
          f"steps fed by it {[round(t, 1) for t in b_step_ms]} ms (mean after the first {warm(b_step_ms):.1f}; "
          f"phase [4]'s stage 1 {warm(step_ms['stage1']):.1f}); two epochs each in turns: " + "; ".join(
              f"{k} {[round(t, 1) for t in v]} (mean {mean(v):.1f})" for k, v in b_turns.items()))
    print(f"  calibration (detect_table, extract_crystal_spec, refine_crystal_spec iters=2): {cal_ms['cuda']:.1f} ms "
          f"with the rebin on cuda, {cal_ms['cpu']:.1f} ms on cpu")
    print(f"  fp32 layers against float64: patch embedding {fp32_errs[0]:.2e}, segmentation head {fp32_errs[1]:.2e}; "
          f"the TF32 control {fp32_control[0]:.2e}, {fp32_control[1]:.2e}")
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
    print("[17] the model's remaining features at the published width: remat, dropout, shifted windows, "
          "attn_chunk; a deterministic backward")
    batch17 = training_batches(1, TRAIN_B, rng)[0]
    main_path = add(main_path, remat_steps(batch17), dropout_checks(rng))
    shift_and_chunk_checks()
    nondeterministic_ops(batch17)
    resize_checks(gen)
    print("[18] data parallelism: dryrun_multichip over NCCL, and two ranks on one card over gloo")
    dp_checks()
    print(f"[19] the user's recipes at the published width, [{RECIPE_B}, 2, {H}, {W}]: quality_run (bf16, "
          f"SmoothL1SSIMLoss, keep-best, flip-augment, remat, attn_chunk=8192, fused_blocks), the first bf16 "
          f"step of each stage against the plain versions, quality_continue, rl_run, classical_baselines, "
          f"train_synthetic")
    main_path = add(main_path, recipes_phase())
    print("[20] entry(): the published model's serving function on its example image")
    entry_check()
    print(f"[22] the compiled programs: serving ({B}, 1 and {FLAGSHIP_B} images, unfused at {UNFUSED_B}, and "
          f"{FLAGSHIP_B} a card on the data mesh), the RL step (bf16 B={RL_B}) and training steps "
          f"(fp32 B={TRAIN_B} fused_deep, bf16 B={RECIPE_B} remat) replaying CUDA graphs, against the same pipelines "
          f"and steps run eagerly")
    main_path = add(main_path, programs_phase(rng, lines))
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
