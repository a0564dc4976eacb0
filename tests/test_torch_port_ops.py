"""The port's ops (swinwnet_tpu_torch/ops: norms, window, resize) against
`swinwnet_tpu.ops` and the JAX package's window helpers, on the same numpy
inputs. Reshapes and pads are exact; the arithmetic ops are fp32 on both
sides (tolerance 1e-6 relative, the fp32 rounding of a few operations)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from swinwnet_tpu.models.layers import _window_pad_mask_np as jax_pad_mask
from swinwnet_tpu.models.layers import relative_position_index as jax_rpi
from swinwnet_tpu.ops import norms as jnorms
from swinwnet_tpu.ops import resize as jresize
from swinwnet_tpu.ops import window as jwindow
from swinwnet_tpu_torch.ops import norms, resize, window

torch.set_num_threads(1)


def _close(got, want, rtol=1e-6):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=rtol * max(np.abs(want).max(), 1e-6))


@pytest.mark.parametrize("channels", [1, 2])
def test_ensure_2ch(channels):
    x = np.random.default_rng(0).normal(size=(2, channels, 7, 9)).astype(np.float32)
    _close(norms.ensure_2ch(torch.from_numpy(x)), jnorms.ensure_2ch(jnp.asarray(x)))


def test_normalize_denormalize_piecewise():
    x = np.random.default_rng(1).uniform(0, 1e3, size=(3, 2, 11, 13)).astype(np.float32)
    x[0, 0, :4] = 0.0  # pixels below the threshold take the linear branch
    got, p = norms.normalize_piecewise(torch.from_numpy(x))
    want, jp = jnorms.normalize_piecewise(jnp.asarray(x))
    _close(got, want)
    _close(p["x_min"], jp["x_min"])
    _close(p["x_max"], jp["x_max"])
    _close(norms.denormalize_piecewise(got, p), jnorms.denormalize_piecewise(want, jp), rtol=2e-6)


@pytest.mark.parametrize("hw", [(10, 15), (13, 24), (63, 120)])
def test_window_partition_reverse(hw):
    x = np.random.default_rng(2).normal(size=(2, *hw, 6)).astype(np.float32)
    got, (Hp, Wp) = window.window_partition(torch.from_numpy(x), 5)
    want, jhw = jwindow.window_partition(jnp.asarray(x), 5)
    assert (Hp, Wp) == jhw
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    back = window.window_reverse(got, 5, Hp, Wp)
    np.testing.assert_array_equal(back.numpy(), np.asarray(jwindow.window_reverse(want, 5, Hp, Wp)))
    np.testing.assert_array_equal(back[:, : hw[0], : hw[1]].numpy(), x)


@pytest.mark.parametrize("hw", [(10, 15), (13, 24)])
def test_window_partition_cmajor(hw):
    """[C, N, Wt]: a permutation of the token-major windows."""
    x = np.random.default_rng(3).normal(size=(3, *hw, 4)).astype(np.float32)
    got, (Hp, Wp) = window.window_partition_cmajor(torch.from_numpy(x), 5)
    want, jhw = jwindow.window_partition_cmajor(jnp.asarray(x), 5)
    assert (Hp, Wp) == jhw
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    tok, _ = window.window_partition(torch.from_numpy(x), 5)
    np.testing.assert_array_equal(got.numpy(), tok.permute(2, 1, 0).numpy())
    back = window.window_reverse_cmajor(got, 5, Hp, Wp)
    np.testing.assert_array_equal(back.numpy(), np.asarray(jwindow.window_reverse_cmajor(want, 5, Hp, Wp)))


@pytest.mark.parametrize("ws", [5, 7])
def test_relative_position_index(ws):
    np.testing.assert_array_equal(window.relative_position_index(ws), jax_rpi(ws))


@pytest.mark.parametrize("hw", [(25, 30), (63, 120), (13, 15), (23, 31)])
def test_window_pad_mask(hw):
    got, want = window.window_pad_mask_np(*hw, 5), jax_pad_mask(*hw, 5)
    if want is None:
        assert got is None
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("src,dst", [((25, 30), (50, 60)), ((125, 240), (250, 480)), ((12, 20), (5, 7))])
def test_bilinear_resize(src, dst):
    """F.interpolate(bilinear, align_corners=False) against the JAX gather
    form, up and down."""
    x = np.random.default_rng(4).normal(size=(2, 1, *src)).astype(np.float32)
    _close(resize.bilinear_resize(torch.from_numpy(x), *dst), jresize.bilinear_resize(jnp.asarray(x), *dst), rtol=2e-6)
