"""Dropout in the port: `drop`, `attn_drop` and `drop_path` act only in a
forward called with `deterministic=False`, with flax's semantics, from the
caller's generator.

* A tiny SwinWNet with every rate 0.1 at deterministic=True against JAX at
  deterministic=True, through the fused gate (128-window rule lowered,
  JAX's interpret switch and SWINWNET_FUSED_DEEP on, as the trainer tests
  run it), and rates 0 at deterministic=False against JAX at
  deterministic=False, which takes the unfused blocks on both sides: 1e-5
  of max|want| (the fp32 difference measured is ~1e-7 of max).
* What JAX cannot be compared on, since its draws are its own: the keep
  statistics and the 1/(1-p) scale, rate 1, element-wise drop_path, which
  modules draw (not the bottleneck), seeds, and remat's recompute drawing
  the forward's masks."""

import jax
import numpy as np
import pytest
import torch

import _torch_port_helpers as h
from swinwnet_tpu.models import SwinWNet as JaxSwinWNet
from swinwnet_tpu_torch.models import BasicLayer, SwinTransformerBlock, SwinWNet, init_weights
from swinwnet_tpu_torch.models import layers
from swinwnet_tpu_torch.ops import swin_block as sb

torch.set_num_threads(1)

RATES = dict(drop=0.1, attn_drop=0.1, drop_path=0.1)


@pytest.fixture
def lowered_window_rule(monkeypatch):
    monkeypatch.setenv("SWINWNET_FUSED_INTERPRET", "1")
    monkeypatch.setenv("SWINWNET_FUSED_DEEP", "1")
    monkeypatch.setattr(BasicLayer, "min_windows", 1)


def tiny_images(seed, batch=2):
    return np.random.default_rng(seed).uniform(0, 1e3, (batch, 2, h.TINY_H, h.TINY_W)).astype(np.float32)


def _jax_seg_and_sr(params, x, deterministic, **rates):
    model = JaxSwinWNet(**h.TINY, use_pallas=True, **rates)

    def run(p, x):
        seg, skips = model.apply(p, x, deterministic=deterministic, method=JaxSwinWNet.segment_1)
        sr, _ = model.apply(p, x, skips, deterministic=deterministic, method=JaxSwinWNet.upscale)
        return seg, sr

    return jax.jit(run)(params, x)


@pytest.mark.parametrize("rates,deterministic", [(RATES, True), ({}, False)])
def test_model_matches_jax(lowered_window_rule, rates, deterministic):
    """segment_1 and upscale, whose levels carry the rates (the SR head's
    too). At deterministic=True the full W pass also equals the rates-0
    model's bit for bit."""
    params = h.jax_params(seed=11, cfg=h.TINY)
    x = tiny_images(11)
    want = _jax_seg_and_sr(params, x, deterministic, **rates)
    port = h.tiny_port(params, **rates)
    sb.reset_counts()
    with torch.no_grad():
        seg, skips = port.segment_1(torch.from_numpy(x), deterministic)
        got = (seg, port.upscale(torch.from_numpy(x), skips, deterministic)[0])
    for name, g, w in zip(("seg", "sr"), got, want):
        h.assert_close(g, np.asarray(w), tol=1e-5, name=name)
    calls = sum(k.plain_calls for k in sb.KERNELS)
    assert (calls > 0) == deterministic  # the fused gate, or the unfused blocks throughout
    if deterministic:
        with torch.no_grad():
            for a, b in zip(port(torch.from_numpy(x)), h.tiny_port(params)(torch.from_numpy(x))):
                assert torch.equal(a, b)


def test_the_gate_is_shut_when_not_deterministic():
    layer = BasicLayer(48, 2, 3, fused_blocks=True, fused_deep=True, **RATES)
    assert layer.fused_route(4, 125, 240) == "cmajor"
    assert layer.fused_route(4, 125, 240, deterministic=False) == ""
    deep = BasicLayer(384, 2, 24, fused_blocks=True, fused_deep=True)
    assert deep.fused_route(8, 16, 30) == "rowmajor" and deep.fused_route(8, 16, 30, False) == ""


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_keep_statistics_and_scale(dtype, rate):
    x = torch.ones(1 << 20, dtype=dtype)
    y = layers.dropout(x, rate, False, torch.Generator().manual_seed(0))
    kept = y != 0
    assert abs(kept.float().mean().item() - (1 - rate)) < 0.005
    assert y.dtype == dtype
    assert torch.equal(y[kept], torch.full_like(y[kept], 1.0) / (1 - rate))
    assert layers.dropout(x, rate, True) is x and layers.dropout(x, 0.0, False) is x


def test_rate_one_zeroes_the_branch():
    x = torch.randn(3, 25, 12, generator=torch.Generator().manual_seed(1))
    assert torch.equal(layers.dropout(x, 1.0, False), torch.zeros_like(x))
    blk = SwinTransformerBlock(12, 3, 5, 4.0, True, torch.float32, drop_path=1.0)
    init_weights(blk, torch.Generator().manual_seed(1))
    with torch.no_grad():
        assert torch.equal(blk(x, None, deterministic=False), x)  # both residual branches dropped
        assert not torch.equal(blk(x), x)


def test_drop_path_drops_elements_not_samples(monkeypatch):
    seen = []

    def spy(x, rate, deterministic, generator=None):
        y = layers_dropout(x, rate, deterministic, generator)
        if rate == 0.5 and not deterministic:
            seen.append((x, y))
        return y

    layers_dropout = layers.dropout
    monkeypatch.setattr(layers, "dropout", spy)
    blk = SwinTransformerBlock(12, 3, 5, 4.0, True, torch.float32, drop_path=0.5)
    init_weights(blk, torch.Generator().manual_seed(2))
    with torch.no_grad():
        blk(torch.randn(8, 25, 12, generator=torch.Generator().manual_seed(2)), None, False,
            torch.Generator().manual_seed(2))
    assert len(seen) == 2  # the attention and the MLP branch
    for x, y in seen:
        dropped = (y == 0) & (x != 0)
        per_sample = dropped.reshape(x.shape[0], -1).float().mean(1)
        assert ((per_sample > 0.3) & (per_sample < 0.7)).all()  # every sample part dropped, none whole


def test_what_draws(monkeypatch):
    """Six draws a block (attention probabilities, its projection, two MLP
    drops, two drop-paths) in every level but the bottleneck, which the
    models build without rates, as the JAX models do."""
    draws = []
    real = layers.dropout

    def count(x, rate, deterministic, generator=None):
        if not deterministic and rate > 0:
            draws.append(tuple(x.shape))
        return real(x, rate, deterministic, generator)

    monkeypatch.setattr(layers, "dropout", count)
    m = SwinWNet(**h.TINY, **RATES, device="cpu")
    assert not m.segmentator_bottleneck.layer.has_dropout and m.segmentator_encoder.layers[0].has_dropout
    x = torch.from_numpy(tiny_images(3))
    with torch.no_grad():
        _, skips = m.segment_1(x, deterministic=False, generator=torch.Generator().manual_seed(3))
        assert len(draws) == 6 * (4 + 3)  # encoder and decoder levels, depth 1
        draws.clear()
        m.segmentator_bottleneck(skips[-1], deterministic=False, generator=torch.Generator().manual_seed(3))
        assert draws == []
        m.upscale(x, skips, deterministic=False, generator=torch.Generator().manual_seed(3))
        assert len(draws) == 6 * (4 + 3 + 2 * 2)  # and the SR head's two levels of depth 2


def test_one_seed_gives_one_output_and_two_seeds_two():
    m = SwinWNet(**h.TINY, **RATES, device="cpu")
    x = torch.from_numpy(tiny_images(4))
    run = lambda seed: m.segment_1(x, False, torch.Generator().manual_seed(seed))[0]
    with torch.no_grad():
        a, b, c, det = run(0), run(0), run(1), m.segment_1(x)[0]
    assert torch.equal(a, b)
    assert not torch.equal(a, c) and not torch.equal(a, det)


def test_remat_with_dropout_gives_the_gradients_of_no_remat():
    """Each block's draws come from a generator built from a seed drawn
    outside the checkpoint, so the recompute drops what the forward did."""
    grads = {}
    for remat in (False, True):
        m = SwinWNet(**h.TINY, **RATES, remat=remat, device="cpu")
        seg, _ = m.segment_1(torch.from_numpy(tiny_images(5)), False, torch.Generator().manual_seed(5))
        seg.square().mean().backward()
        grads[remat] = {k: p.grad for k, p in m.named_parameters() if p.grad is not None}
    assert grads[True].keys() == grads[False].keys() and len(grads[True]) > 50
    for k, g in grads[False].items():
        np.testing.assert_allclose(grads[True][k].numpy(), g.numpy(), rtol=0,
                                   atol=1e-6 * float(g.abs().max()), err_msg=k)
