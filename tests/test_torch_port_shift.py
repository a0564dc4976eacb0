"""Shifted windows in the port against the JAX package on the CPU:
`compute_mask` equal to JAX's exactly; the shifted SwinTransformerBlock
and BasicLayer(shift_size=2) on a grid that tiles by the window and on one
that does not (fp32, 1e-5 of max|want|: the same fp32 math in another
summation order); the JAX test's constant-input invariance
(tests/test_data_utils.py:144-166, same tolerance); and a shifted level
never takes a fused route."""

import jax
import numpy as np
import pytest
import torch

import _torch_port_helpers as h
from swinwnet_tpu.models.layers import BasicLayer as JaxBasicLayer
from swinwnet_tpu.models.layers import SwinTransformerBlock as JaxBlock
from swinwnet_tpu.ops.window import compute_mask as jax_compute_mask
from swinwnet_tpu_torch.compat import state_dict_from_jax
from swinwnet_tpu_torch.models import BasicLayer, SwinTransformerBlock, init_weights
from swinwnet_tpu_torch.ops import swin_block as sb
from swinwnet_tpu_torch.ops.window import compute_mask, window_partition

torch.set_num_threads(1)

C, NH = 12, 3
GRIDS = [(10, 10), (12, 13)]  # tiles by the window of 5; does not


def grid_input(hw, seed=0, batch=2):
    return np.random.default_rng(seed).standard_normal((batch, *hw, C)).astype(np.float32)


@pytest.mark.parametrize("H,W", GRIDS)
def test_compute_mask_equals_jax_exactly(H, W):
    got = compute_mask(H, W, 5, 2)
    want = np.asarray(jax_compute_mask(H, W, 5, 2))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    assert set(np.unique(want)) == {0.0, -100.0}
    assert got.shape == ((-(-H // 5)) * (-(-W // 5)), 25, 25)


def _port_block(params, shift):
    blk = SwinTransformerBlock(C, NH, 5, 4.0, True, torch.float32, shift_size=shift)
    blk.load_state_dict(state_dict_from_jax(params), strict=True)
    return blk.eval()


@pytest.mark.parametrize("H,W", GRIDS)
def test_shifted_block_matches_jax(H, W):
    x = grid_input((H, W), seed=H)
    jblk = JaxBlock(dim=C, num_heads=NH, window_size=5, shift_size=2)
    params = h.draw_params(jblk, x.shape, seed=W)
    want = np.asarray(jblk.apply(params, x))
    with torch.no_grad():
        got = _port_block(params, 2)(torch.from_numpy(x))
    h.assert_close(got, want, tol=1e-5, name="shifted block")


@pytest.mark.parametrize("H,W", GRIDS)
def test_shifted_basic_layer_matches_jax(H, W):
    x = grid_input((H, W), seed=H + 1)
    jlayer = JaxBasicLayer(dim=C, depth=2, num_heads=NH, window_size=5, shift_size=2)
    params = h.draw_params(jlayer, x.shape, seed=W + 1)
    want = np.asarray(jlayer.apply(params, x))
    layer = BasicLayer(C, 2, NH, 5, shift_size=2).eval()
    layer.load_state_dict(state_dict_from_jax(params), strict=True)
    with torch.no_grad():
        got = layer(torch.from_numpy(x))
    h.assert_close(got, want, tol=1e-5, name="shifted layer")


def test_shifted_block_constant_input_invariance():
    """Every token of a constant grid is the same, so the roll and the mask
    cannot change the block's output: shifted equals unshifted."""
    x = torch.from_numpy(grid_input((10, 10), batch=1))
    params = h.draw_params(JaxBlock(dim=C, num_heads=NH, window_size=5, shift_size=2), x.shape, seed=3)
    shifted, plain = _port_block(params, 2), _port_block(params, 0)
    with torch.no_grad():
        y = shifted(x)
        assert y.shape == x.shape and torch.isfinite(y).all()
        xc = torch.full((1, 10, 10, C), 0.3)
        np.testing.assert_allclose(shifted(xc).numpy(), plain(xc).numpy(), rtol=1e-5, atol=1e-6)


def test_unshifted_block_on_a_grid_equals_the_windowed_layout():
    """At shift 0 the block takes either layout: the grid route pads after
    LN1, the windowed one zeroes pad slots after LN1 with the pad mask."""
    from swinwnet_tpu_torch.models.layers import _pad_mask_tensor
    from swinwnet_tpu_torch.ops.window import window_reverse

    blk = SwinTransformerBlock(C, NH, 5, 4.0, True, torch.float32)
    init_weights(blk, torch.Generator().manual_seed(4))
    x = torch.from_numpy(grid_input((12, 13), seed=4))
    xw, (Hp, Wp) = window_partition(x, 5)
    with torch.no_grad():
        grid = blk(x)
        windowed = window_reverse(blk(xw, _pad_mask_tensor(12, 13, 5, 2, "windows", "cpu")), 5, Hp, Wp)
    np.testing.assert_allclose(grid.numpy(), windowed[:, :12, :13].numpy(), rtol=0, atol=1e-6)


def test_a_shifted_block_refuses_window_tokens():
    blk = SwinTransformerBlock(C, NH, 5, 4.0, True, torch.float32, shift_size=2)
    with pytest.raises(ValueError, match="grid"):
        blk(torch.zeros(4, 25, C))


def test_a_shifted_level_never_fuses(monkeypatch):
    monkeypatch.setattr(BasicLayer, "min_windows", 1)
    shifted = BasicLayer(48, 2, 3, fused_blocks=True, fused_deep=True, shift_size=2).eval()
    init_weights(shifted, torch.Generator().manual_seed(5))
    unshifted = BasicLayer(48, 2, 3, fused_blocks=True, fused_deep=True).eval()
    assert unshifted.fused_route(2, 25, 30) == "cmajor"
    assert shifted.fused_route(2, 25, 30) == "" and not shifted.uses_kernel(2, 25, 30)
    sb.reset_counts()
    with torch.no_grad():
        y = shifted(torch.randn(2, 25, 30, 48, generator=torch.Generator().manual_seed(5)))
    assert torch.isfinite(y).all()
    assert [k.plain_calls for k in sb.KERNELS] == [0, 0, 0]
