"""The port's launch table: what one serving call, training step or RL step
of the published models launches, per kernel entry, at the detector
geometry ([B, 2|1, 250, 480]), through each caller's public entry point.

Each case's table is pinned to the card's numbers (PERF.md §3 and §6, where
chip_smoke.py's launch checks and the benchmark's counters read them on the
H100): 22 cst a bf16 SwinWNet serving call at any batch (4 of them the
narrow body) and 10 in fp32, 16 wide on the `nmajor` route, 11
`patch_expand_norm` a SwinWNet serving call and 3 a SwinUNet one, 30
`window_attention` a bf16 SwinWNet serving call at any batch and 10 a
SwinUNet or SwinUNetSR one; 6 cst a bf16 SwinUNet call and 2 an fp32 one,
10 a SwinUNetSR call; 2 / 8 / 8 / 10
cst and 14 / 24 / 24 / 42 row-major an fp32 `fused_deep` step (stage 1 / 2 /
3 even / 3 odd), 2 wide an `nmajor` stage-1 step; 26 cst a bf16 RL step (8
of them narrow, as chip_smoke.py [22] reads it) and 14 an fp32 one, each
with one distance gate and one reward. The bf16 steps at B=4 are
chip_smoke.py's `expected_launches`: 6 / 16 / 16 / 22 cst; their narrow
counts (4 in stages 2 and 3) follow from the rule below and were not read
on the card.

Each pinned table is also held against the JAX package: the cst, row-major
and wide counts are its gate's (`swinwnet_tpu/models/layers.py`, read from
the traced program of each level with the backend reported as "tpu"), level
by level over the towers each call or step runs, two blocks a level. The
counts with no JAX counterpart follow rules: in bf16 a kernel level of
C <= 24 (the SR head's) takes the narrow body; a serving call's towers
expand 3 times each and an SR head twice more (SwinWNet 3 + 3 + 2 + 3,
SwinUNetSR 3 + 2), training and RL steps never through the kernel; in bf16
serving each block of a level the gate leaves unfused launches the window
attention kernel where it takes the level's head width (16 or 32), and
training and RL steps never do.

The models are built on the `meta` device, so nothing is computed and a
case takes about a second. The three launch seams, `ops.swin_block._launch`,
`ops.expand_norm.patch_expand_norm` and `ops.window_attention.window_attention`,
run as they are but for their device guard, which is widened to `meta`; the libraries they load are
replaced by ones whose launches return success. So the operand checks, the
plan and the counting are the card's. A level that the gate
(`BasicLayer.fused_route`) sends off its kernel leaves a count short.
"""

import contextlib
import functools
import inspect
import re
import textwrap
import types

import jax
import jax.numpy as jnp
import pytest
import torch

from swinwnet_tpu.models import BasicLayer as JaxBasicLayer
from swinwnet_tpu_torch.models import AlphaPolicy, SwinUNet, SwinUNetSR, SwinWNet
from swinwnet_tpu_torch.models import layers as layers_mod
from swinwnet_tpu_torch.ops import expand_norm as en
from swinwnet_tpu_torch.ops import swin_block as sb
from swinwnet_tpu_torch.ops import window_attention as wa
from swinwnet_tpu_torch.physics import Qwrapper, d_centers_hr
from swinwnet_tpu_torch.pipelines import (
    make_inference_fn,
    make_rl_inference_fn,
    make_segmentation_fn,
    make_split_inference_fn,
    make_sr_fn,
)
from swinwnet_tpu_torch.train import (
    AdamW,
    RLState,
    TrainState,
    combined_loss,
    make_rl_train_step,
    make_stage1_step,
    make_stage2_step,
    make_stage3_steps,
    masked_adamw,
    smooth_l1_loss,
    smooth_l1_ssim_loss,
)
from swinwnet_tpu_torch.utils import profiling

torch.set_num_threads(1)

H, W = 250, 480
PUBLISHED = dict(patch_size=2, embed_dim=48, depths=(2, 2, 2, 2), num_heads=(3, 6, 12, 24), window_size=5,
                 fused_blocks=True, device="meta")
WNET = dict(in_chans=1, error_matrix=True, **PUBLISHED)
COUNTED = ("fused_swin_block_cst", "fused_swin_block", "fused_swin_block_wide", "swin_block_narrow",
           "patch_expand_norm", "window_attention", "distance_gate", "rl_reward")


def on_meta(fn):
    """`fn` compiled from its own source with only its device guard widened
    to the `meta` device."""
    lines, first = inspect.getsourcelines(fn)
    src = textwrap.dedent("".join(lines))
    guard = '.device.type != "cuda":'
    assert src.count(guard) == 1, f"{fn.__name__} has no single device guard"
    code = compile("\n" * (first - 1) + src.replace(guard, '.device.type not in ("cuda", "meta"):'),
                   inspect.getsourcefile(fn), "exec")
    namespace = {}
    exec(code, fn.__globals__, namespace)
    return namespace[fn.__name__]


LAUNCH, EXPAND, ATTEND = on_meta(sb._launch), on_meta(en.patch_expand_norm), on_meta(wa.window_attention)
LIBRARY = types.SimpleNamespace(swin_block_launch=lambda *args: 0, expand_norm_launch=lambda *args: 0,
                                window_attention_launch=lambda *args: 0)


@pytest.fixture(autouse=True)
def meta_seams(monkeypatch):
    monkeypatch.setattr(sb, "_launch", LAUNCH)
    monkeypatch.setattr(sb, "_load", lambda: LIBRARY)
    monkeypatch.setattr(layers_mod, "patch_expand_norm", EXPAND)
    monkeypatch.setattr(en, "_load", lambda: LIBRARY)
    monkeypatch.setattr(layers_mod, "window_attention", ATTEND)
    monkeypatch.setattr(wa, "_load", lambda: LIBRARY)
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: types.SimpleNamespace(cuda_stream=0))


def counts_of(call):
    """Each counted entry's launches over one `call()`."""
    before = profiling.counters()
    call()
    after = profiling.counters()
    return {k: after[k] - before[k] for k in COUNTED}


def table(**counts):
    return {**dict.fromkeys(COUNTED, 0), **counts}


def images(batch, chans=2):
    return torch.rand(batch, chans, H, W, device="meta")


# The JAX reference: a tower pass's Swin levels, two blocks each, as (C,
# heads, grid) with the grid as the k-th halving of the patch grid (encoder,
# bottleneck, decoder), and the SR head's at 2x and 4x it
TOWER = [(48, 3, 0), (96, 6, 1), (192, 12, 2), (384, 24, 3), (384, 24, 3), (384, 12, 2), (192, 6, 1), (96, 3, 0)]
SR_HEAD = [(24, 3, -1), (12, 3, -2)]
FULL, HALF = (H, W), (H // 2, W // 2)
SEG, UP, UP_HALF = ("seg", FULL), ("up", FULL), ("up", HALF)
JAX_DTYPES = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
JAX_ENTRIES = ("fused_swin_block_cst", "fused_swin_block", "fused_swin_block_wide")


def grid_of(image_hw, k):
    ceil_half = lambda g: (-(-g[0] // 2), -(-g[1] // 2))
    grid = ceil_half(image_hw)
    if k < 0:
        return grid[0] << -k, grid[1] << -k
    for _ in range(k):
        grid = ceil_half(grid)
    return grid


@functools.cache
def jax_layer(C, num_heads, dtype):
    layer = JaxBasicLayer(dim=C, depth=1, num_heads=num_heads, window_size=5, use_pallas=True,
                          dtype=JAX_DTYPES[dtype])
    return layer, jax.eval_shape(layer.init, jax.random.PRNGKey(0), jnp.zeros((1, 5, 5, C), JAX_DTYPES[dtype]))


@functools.cache
def jax_entry(C, num_heads, dtype, batch, grid, fused_deep, fused_layout):
    """The JAX gate's fused entry point for one level, or None."""
    layer, variables = jax_layer(C, num_heads, dtype)
    x = jax.ShapeDtypeStruct((batch, *grid, C), JAX_DTYPES[dtype])
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax, "default_backend", lambda: "tpu")
        mp.delenv("SWINWNET_FUSED_INTERPRET", raising=False)
        mp.setenv("SWINWNET_FUSED_DEEP", "1" if fused_deep else "0")
        mp.setenv("SWINWNET_FUSED_LAYOUT", fused_layout)
        jaxpr = str(jax.make_jaxpr(layer.apply)(variables, x))
    entries = set(re.findall(r"name=(fused_swin_block\w*)", jaxpr))
    assert len(entries) <= 1 and entries <= set(JAX_ENTRIES)
    return entries.pop() if entries else None


def reference(passes, dtype, batch, serving, fused_deep=False, fused_layout="cmajor", rl=False):
    """The table of one call or step that runs the tower `passes`: the
    kernel entries by the JAX gate, the narrow body, the expansions and the
    unfused levels' window attention by their rules, the RL step's gate and
    reward once each."""
    want = table(distance_gate=int(rl), rl_reward=int(rl))
    for tower, image_hw in passes:
        for C, num_heads, k in TOWER + (SR_HEAD if tower == "up" else []):
            entry = jax_entry(C, num_heads, dtype, batch, grid_of(image_hw, k), fused_deep, fused_layout)
            if entry:
                want[entry] += 2
                want["swin_block_narrow"] += 2 * (dtype == "bfloat16" and C <= sb.NARROW_MAX_C)
            else:
                want["window_attention"] += 2 * (serving and dtype == "bfloat16" and wa.takes(C, num_heads, 25))
        want["patch_expand_norm"] += (3 + 2 * (tower == "up")) * serving
    return want


def swinwnet_serving(route, dtype, **kw):
    model = SwinWNet(dtype=dtype, **WNET, **kw).eval()
    if route == "split":
        return make_split_inference_fn(model)
    if route == "rl":
        return make_rl_inference_fn(model, AlphaPolicy(device="meta"))
    return make_inference_fn(model)


WNET_CALL = [SEG, UP, SEG]
SERVE_BF16 = table(fused_swin_block_cst=22, swin_block_narrow=4, patch_expand_norm=11, window_attention=30)
SERVING = {
    "bf16 B=1": ("single", "bfloat16", 1, {}, SERVE_BF16),
    "bf16 B=4": ("single", "bfloat16", 4, {}, SERVE_BF16),
    "bf16 B=64": ("single", "bfloat16", 64, {}, SERVE_BF16),
    "fp32 B=4": ("single", "float32", 4, {}, table(fused_swin_block_cst=10, patch_expand_norm=11)),
    "bf16 nmajor B=4": ("single", "bfloat16", 4, {"fused_layout": "nmajor"},
                        table(fused_swin_block_wide=16, swin_block_narrow=4, patch_expand_norm=11,
                              window_attention=36)),
    "bf16 split B=4": ("split", "bfloat16", 4, {}, SERVE_BF16),
    "bf16 RL B=4": ("rl", "bfloat16", 4, {}, SERVE_BF16),
}


@pytest.mark.parametrize("case", list(SERVING))
def test_swinwnet_serving_call(case):
    """`make_inference_fn`, the split route's three programs and
    `make_rl_inference_fn`: one call's launches."""
    route, dtype, batch, kw, want = SERVING[case]
    assert reference(WNET_CALL, dtype, batch, serving=True, **kw) == want
    fn = swinwnet_serving(route, dtype, **kw)
    assert counts_of(lambda: fn(images(batch))) == want


TOWERS = {
    "SwinUNet bf16 B=64": (SwinUNet, "bfloat16", 64, table(fused_swin_block_cst=6, patch_expand_norm=3,
                                                           window_attention=10)),
    "SwinUNet fp32 B=64": (SwinUNet, "float32", 64, table(fused_swin_block_cst=2, patch_expand_norm=3)),
    "SwinUNetSR bf16 B=4": (SwinUNetSR, "bfloat16", 4, table(fused_swin_block_cst=10, swin_block_narrow=4,
                                                             patch_expand_norm=5, window_attention=10)),
}


@pytest.mark.parametrize("case", list(TOWERS))
def test_single_tower_call(case):
    """`make_segmentation_fn(SwinUNet)` and `make_sr_fn(SwinUNetSR)`: one
    call's launches on a one-channel pattern."""
    cls, dtype, batch, want = TOWERS[case]
    assert reference([SEG if cls is SwinUNet else UP], dtype, batch, serving=True) == want
    if cls is SwinUNet:
        fn = make_segmentation_fn(SwinUNet(in_chans=1, dtype=dtype, **PUBLISHED).eval())
    else:
        fn = make_sr_fn(SwinUNetSR(dtype=dtype, **PUBLISHED).eval())
    assert counts_of(lambda: fn(images(batch, 1))) == want


def training_step(kind, dtype, **kw):
    """The factories' step of `kind` on an fp32 model with its state, in
    `dtype` compute (bf16 with the SmoothL1-SSIM upscaler loss, as the
    recipes train)."""
    model = SwinWNet(dtype="float32", **WNET, **kw).train()
    tx = masked_adamw(model, kind if kind in ("stage1", "stage2") else "stage3", 1e-4)
    state = TrainState.create(model, tx)
    compute_dtype = None if dtype == "float32" else "bfloat16"
    sr_loss = smooth_l1_loss if dtype == "float32" else smooth_l1_ssim_loss
    if kind == "stage1":
        step = make_stage1_step(model, tx, combined_loss, compute_dtype)
    elif kind == "stage2":
        step = make_stage2_step(model, tx, sr_loss, compute_dtype)
    else:
        even, odd, _, _ = make_stage3_steps(model, tx, combined_loss, sr_loss, compute_dtype=compute_dtype)
        step = even if kind == "stage3_even" else odd
    return lambda batch: step(state, images(batch, 1), torch.rand(batch, H, W, device="meta"))


# the towers of each step: stage 2 and stage 3's even step upscale the half-size image
STEP_PASSES = {"stage1": [SEG], "stage2": [SEG, UP_HALF], "stage3_even": [SEG, UP_HALF],
               "stage3_odd": [SEG, UP, SEG]}
DEEP = {"fused_deep": True}
REMAT = {"remat": True, "attn_chunk": 8192}
STEPS = {
    "stage1 fp32 fused_deep B=8": ("stage1", "float32", 8, DEEP, table(fused_swin_block_cst=2, fused_swin_block=14)),
    "stage2 fp32 fused_deep B=8": ("stage2", "float32", 8, DEEP, table(fused_swin_block_cst=8, fused_swin_block=24)),
    "stage3_even fp32 fused_deep B=8": ("stage3_even", "float32", 8, DEEP,
                                        table(fused_swin_block_cst=8, fused_swin_block=24)),
    "stage3_odd fp32 fused_deep B=8": ("stage3_odd", "float32", 8, DEEP,
                                       table(fused_swin_block_cst=10, fused_swin_block=42)),
    "stage1 fp32 fused_deep nmajor B=8": ("stage1", "float32", 8, {**DEEP, "fused_layout": "nmajor"},
                                          table(fused_swin_block_wide=2, fused_swin_block=14)),
    "stage1 bf16 remat B=4": ("stage1", "bfloat16", 4, REMAT, table(fused_swin_block_cst=6)),
    "stage2 bf16 remat B=4": ("stage2", "bfloat16", 4, REMAT, table(fused_swin_block_cst=16, swin_block_narrow=4)),
    "stage3_even bf16 remat B=4": ("stage3_even", "bfloat16", 4, REMAT,
                                   table(fused_swin_block_cst=16, swin_block_narrow=4)),
    "stage3_odd bf16 remat B=4": ("stage3_odd", "bfloat16", 4, REMAT,
                                  table(fused_swin_block_cst=22, swin_block_narrow=4)),
}


@pytest.mark.parametrize("case", list(STEPS))
def test_training_step(case):
    """`make_stage1_step`, `make_stage2_step` and `make_stage3_steps`: one
    step's launches (the backward recomputes in plain torch and launches
    nothing)."""
    kind, dtype, batch, kw, want = STEPS[case]
    routing = {k: v for k, v in kw.items() if k in ("fused_deep", "fused_layout")}
    assert reference(STEP_PASSES[kind], dtype, batch, serving=False, **routing) == want
    step = training_step(kind, dtype, **kw)
    assert counts_of(lambda: step(batch)) == want


RL_STEPS = {
    "bf16 B=4": ("bfloat16", table(fused_swin_block_cst=26, swin_block_narrow=8, distance_gate=1, rl_reward=1)),
    "fp32 B=4": ("float32", table(fused_swin_block_cst=14, distance_gate=1, rl_reward=1)),
}


@pytest.mark.parametrize("case", list(RL_STEPS))
def test_rl_step(case):
    """`make_rl_train_step`: one step's launches (segment_1, the reward's
    rollout and the update's forward, the last two at half size), its
    distance gate and its reward."""
    dtype, want = RL_STEPS[case]
    assert reference([SEG, UP_HALF, UP_HALF], dtype, 4, serving=False, rl=True) == want
    model, policy = SwinWNet(dtype="float32", **WNET).train(), AlphaPolicy(device="meta")
    model_tx = masked_adamw(model, "rl", 1e-5, weight_decay=0.0)
    policy_tx = AdamW(policy.parameters(), 1e-4, weight_decay=0.0)
    state = RLState(TrainState.create(model, model_tx), TrainState.create(policy, policy_tx), torch.Generator())
    step = make_rl_train_step(model, policy, model_tx, policy_tx, Qwrapper(fixed_centers=d_centers_hr, device="meta"),
                              compute_dtype=None if dtype == "float32" else dtype)
    assert counts_of(lambda: step(state, images(4))) == want
