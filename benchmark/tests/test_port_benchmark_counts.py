"""The yardstick's operation and byte counts against hand sums."""

from __future__ import annotations

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.tests.conftest import tiny_cell
from benchmark.harness import load_cell, metric_file
from benchmark.yardstick import flops, reference


def test_swin_block_cost_by_hand():
    # C = 48, 10 windows of 25 tokens, MLP 4C, bf16
    c = flops.swin_block_cost(48, 10, 25, 4.0, "bfloat16")
    per_window = 2 * 25 * 48 * 144 + 2 * 25 * 48 * 48 + 2 * 2 * 25 * 48 * 192 + 2 * 2 * 25 * 25 * 48
    assert c["flops"] == 10 * per_window
    weights = 2 * (48 * 144 + 48 * 48 + 2 * 48 * 192) + 4 * (144 + 48 + 192 + 48 + 4 * 48)
    assert c["bytes"] == 2 * 10 * 25 * 48 * 2 + weights


@pytest.mark.parametrize("C, heads", [(48, 3), (96, 6), (12, 3)])
def test_swin_block_cost_matches_the_reference_blocks_count(C, heads):
    """The products FlopCounterMode sees in one reference block over a grid
    of whole windows are the block's operations."""
    with torch.device("meta"):
        blk = reference.Block(C, heads, 5, 4.0, reference.Products())
    x = torch.zeros(2, 10, 15, C, device="meta")  # 2 x 2 x 3 windows
    with FlopCounterMode(display=False) as counter:
        blk(x)
    assert counter.get_total_flops() == flops.swin_block_cost(C, 12, 25, 4.0, "float32")["flops"]


def test_fused_levels_of_the_published_models():
    """The gate's launches a serving call: SwinWNet 22 (encoder L0 and L1 and
    the last decoder level in each of three tower passes, the two SR levels),
    SwinUNet 6, at any batch the window rule admits."""
    rule = metric_file("swin_block_roofline.serve")["gate"]["bfloat16"]
    wnet = load_cell("wnet-serve-b64").config
    unet = load_cell("unet-seg-b64").config
    for batch in (1, 4, 64):
        assert flops.swin_block_bound_s(wnet, batch, rule)["launches"] == 22
        assert flops.swin_block_bound_s(unet, batch, rule)["launches"] == 6
    levels = {(lv["C"], lv["heads"]): lv for lv in flops.fused_levels(wnet, 4, rule)}
    assert levels[(48, 3)]["windows"] == 4800 and levels[(48, 3)]["launches"] == 6
    assert levels[(12, 3)]["windows"] == 76800 and levels[(24, 3)]["windows"] == 19200
    # encoder L0 at B=4: 7.3 us a launch on the H100, bound by operations
    one = flops.swin_block_cost(48, 4800, 25, 4.0, "bfloat16")
    assert one["flops"] / flops.PEAK_FLOPS["bfloat16"] == pytest.approx(7.29e-6, rel=1e-2)


def test_model_operations_an_image():
    """About 216 GFLOP an image through the serving pipeline (the port's
    bench counted 216 with every level unfused), a few times fewer for
    SwinUNet; a training step's backward about twice its forward."""
    wnet = load_cell("wnet-serve-b64").config
    n = flops.serving_flops_per_image(wnet)
    assert 200e9 < n < 230e9
    u = flops.serving_flops_per_image(load_cell("unet-seg-b64").config)
    assert 0.1 * n < u < 0.35 * n
    tiny = tiny_cell("wnet-train-s3-b4").config
    t = flops.train_flops_per_image(tiny)
    assert t["odd"] > t["even"] > 0
    fwd = flops.serving_flops_per_image(tiny)
    assert 2 * fwd < t["odd"] < 4 * fwd
