"""The yardstick's arithmetic: the chip's peaks, the model operations an image
costs (counted on the reference), and a fused Swin block's operations, bytes
and roofline bound.

The model count is `FlopCounterMode` over one image of the reference on the
meta device (no memory, no time): products and convolutions, forward (and
backward for a training step), the same whatever computes a block in the
program. A training step's recompute under remat is not counted.
"""

from __future__ import annotations

from typing import Dict, List

import torch
from torch.utils.flop_counter import FlopCounterMode

from . import reference

# NVIDIA H100 SXM, data sheet, dense: tensor-core bf16 and fp32 outside the
# tensor cores; HBM3 bandwidth
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES_PER_S = 3.35e12
BYTES = {"bfloat16": 2, "float32": 4}


def _count(fn) -> int:
    with FlopCounterMode(display=False) as counter:
        fn()
    return int(counter.get_total_flops())


def serving_flops_per_image(config: dict) -> int:
    """Operations of one image through the configuration's serving pipeline."""
    model = reference.build(config, "meta")
    x = torch.zeros(1, config["in_chans"], config["height"], config["width"], device="meta")
    with torch.no_grad():
        return _count(lambda: model.serve(x))


def train_flops_per_image(config: dict) -> Dict[str, int]:
    """Operations of one image through a stage-3 step, forward and backward:
    {"even": ..., "odd": ...}."""
    model = reference.build(config, "meta")
    x = torch.zeros(1, config["in_chans"], config["height"], config["width"], device="meta")
    m = torch.zeros(1, config["height"], config["width"], device="meta")
    return {kind: _count(lambda: reference.stage3_loss(model, x, m, kind == "even").backward())
            for kind in ("even", "odd")}


def fused_levels(config: dict, batch: int, rule: dict) -> List[dict]:
    """The levels that go through a fused Swin-block launch in one call of
    the serving pipeline, by the gate in `rule`: a level of width C at most
    `max_dim` over at least `min_windows` windows of the batch. The levels
    and their grids are those the reference's serving pipeline runs at this
    batch (traced on the meta device). Each entry: C, heads, windows of the
    batch, launches a call."""
    model = reference.build(config, "meta")
    ws = config["window_size"]
    seen: List[tuple] = []

    def record(level, args):
        B, H, W, C = args[0].shape
        seen.append((C, level.blocks[0].attn.heads, B * (-(-H // ws)) * (-(-W // ws)), len(level.blocks)))

    hooks = [m.register_forward_pre_hook(record) for m in model.modules() if isinstance(m, reference.Level)]
    x = torch.zeros(batch, config["in_chans"], config["height"], config["width"], device="meta")
    with torch.no_grad():
        model.serve(x)
    for h in hooks:
        h.remove()
    out: Dict[tuple, dict] = {}
    for dim, nh, windows, depth in seen:
        if dim > rule["max_dim"] or windows < rule["min_windows"]:
            continue
        out.setdefault((dim, nh, windows), {"C": dim, "heads": nh, "windows": windows, "launches": 0})
        out[(dim, nh, windows)]["launches"] += depth
    return list(out.values())


def swin_block_cost(C: int, windows: int, N: int, mlp_ratio: float, dtype: str) -> Dict[str, float]:
    """One fused block over `windows` windows of N tokens: operations
    (qkv, proj and the MLP: 2N(3 + 1 + 2 mlp_ratio)C^2; scores and P.V:
    4N^2C) and bytes (each input and output activation once, the weights and
    biases once a launch)."""
    flops = windows * (2 * N * (4 + 2 * mlp_ratio) * C * C + 4 * N * N * C)
    hidden = int(C * mlp_ratio)
    weights = (3 * C * C + C * C + 2 * C * hidden) * BYTES[dtype] + (3 * C + C + hidden + C + 4 * C) * 4
    act = 2 * windows * N * C * BYTES[dtype]
    return {"flops": float(flops), "bytes": float(act + weights)}


def swin_block_bound_s(config: dict, batch: int, rule: dict) -> Dict[str, float]:
    """The least time one call's fused launches could take on the chip:
    the sum over launches of max(operations / peak, bytes / bandwidth), and
    the launches that sum counts."""
    dtype, N = config["dtype"], config["window_size"] ** 2
    total, launches = 0.0, 0
    for lvl in fused_levels(config, batch, rule):
        cost = swin_block_cost(lvl["C"], lvl["windows"], N, config["mlp_ratio"], dtype)
        one = max(cost["flops"] / PEAK_FLOPS[dtype], cost["bytes"] / PEAK_BYTES_PER_S)
        total += one * lvl["launches"]
        launches += lvl["launches"]
    return {"bound_s": total, "launches": launches}

