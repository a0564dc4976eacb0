"""The port's bilinear resize (swinwnet_tpu_torch/ops/resize.py: two
products with static interpolation matrices) against the JAX package's
gather form and against `F.interpolate(mode="bilinear",
align_corners=False)`, forward and backward, up by 2 and 4 and down, at even
and odd sizes, on the same numpy inputs.

Tolerance: 1e-6 of the max of the reference, forward and backward. Each
output is a two-tap fp32 lerp (each input gradient a sum of a few such
products), so the forms differ only by the rounding of a sum of two or three
terms, about 1e-7 relative. `F.interpolate` computes the source coordinate
from an fp32 scale where the JAX package (and the port) take it in float64:
where in/out is not a power of two, its lerp weights may be off by in·2^-24,
on a difference of two taps of up to twice the max, which adds 2·in·2^-24
to its tolerance (3.7e-6 at in = 31). On the card (marked `cuda`; JAX is
imported only by the tests that need it, so `pytest --noconftest -m cuda`
runs this file there) two backward passes give the same bits."""

import importlib

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from swinwnet_tpu_torch.ops import resize

torch.set_num_threads(1)

TOL = 1e-6
# (input H, W) -> (output H, W): up by 2 and 4 at even and odd sizes (the
# heads' factors), down at odd and even sizes, and the SR head's full-size x4
CASES = [
    ((25, 30), (50, 60)),
    ((13, 15), (26, 30)),
    ((25, 30), (100, 120)),
    ((13, 15), (52, 60)),
    ((12, 20), (5, 7)),
    ((27, 31), (13, 15)),
    ((125, 240), (500, 960)),
]


def _jax():
    """(jax, jax.numpy, the JAX package's resize), imported here so that the
    card's test (no JAX there) can run this file."""
    return (importlib.import_module("jax"), importlib.import_module("jax.numpy"),
            importlib.import_module("swinwnet_tpu.ops.resize"))


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return np.abs(got - want).max() / np.abs(want).max()


def _x(src, seed=0, batch=2):
    return np.random.default_rng(seed).normal(size=(batch, 1, *src)).astype(np.float32)


@pytest.mark.parametrize("src,dst", CASES)
def test_forward_matches_jax(src, dst):
    _, jnp, jresize = _jax()
    x = _x(src)
    got = resize.bilinear_resize(torch.from_numpy(x), *dst)
    assert _rel(got.numpy(), jresize.bilinear_resize(jnp.asarray(x), *dst)) <= TOL


@pytest.mark.parametrize("src,dst", CASES)
def test_forward_matches_interpolate(src, dst):
    x = torch.from_numpy(_x(src, seed=1))
    want = F.interpolate(x, size=dst, mode="bilinear", align_corners=False)
    inexact = [i for i, o in zip(src, dst) if np.log2(i / o) % 1]
    tol = TOL + 2 * max(inexact, default=0) * 2.0 ** -24
    assert _rel(resize.bilinear_resize(x, *dst).numpy(), want.numpy()) <= tol


@pytest.mark.parametrize("src,dst", CASES)
def test_backward_matches_jax_vjp(src, dst):
    jax, jnp, jresize = _jax()
    x = _x(src, seed=2)
    g = np.random.default_rng(3).normal(size=(2, 1, *dst)).astype(np.float32)
    _, vjp = jax.vjp(lambda a: jresize.bilinear_resize(a, *dst), jnp.asarray(x))
    (want,) = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_(True)
    resize.bilinear_resize(xt, *dst).backward(torch.from_numpy(g))
    assert _rel(xt.grad.numpy(), want) <= TOL


@pytest.mark.parametrize("out_size,in_size", [(50, 25), (26, 13), (100, 25), (52, 13), (5, 12), (13, 27),
                                              (500, 125), (960, 240)])
def test_matrix_holds_the_jax_taps(out_size, in_size):
    """Row i of the cached matrix is the JAX `_axis_weights` lerp of output
    i: 1 - w at tap lo, w at tap hi, zero elsewhere."""
    lo, hi, w_hi = _jax()[2]._axis_weights(out_size, in_size)
    want = np.zeros((out_size, in_size), np.float32)
    for i in range(out_size):
        want[i, lo[i]] += 1.0 - w_hi[i]
        want[i, hi[i]] += w_hi[i]
    got = resize.interp_matrix(out_size, in_size, "cpu")
    np.testing.assert_array_equal(got.numpy(), want)
    assert resize.interp_matrix(out_size, in_size, "cpu") is got  # cached


def test_keeps_dtype_and_leading_dims():
    """Any leading dims, and a bf16 input comes back bf16 (computed in fp32);
    the same size is the input itself."""
    x = torch.from_numpy(np.random.default_rng(5).normal(size=(2, 3, 4, 6, 8)).astype(np.float32))
    out = resize.bilinear_resize(x, 12, 16)
    assert out.shape == (2, 3, 4, 12, 16)
    want = F.interpolate(x.reshape(-1, 1, 6, 8), size=(12, 16), mode="bilinear", align_corners=False)
    assert _rel(out.reshape(-1, 1, 12, 16).numpy(), want.numpy()) <= TOL
    bf = resize.bilinear_resize(x.bfloat16(), 12, 16)
    assert bf.dtype == torch.bfloat16
    assert (bf.float() - out).abs().max() <= 2 ** -7 * out.abs().max()
    assert resize.bilinear_resize(x, 6, 8) is x


def test_matrix_built_under_inference_mode_trains():
    """A matrix first built inside inference mode (a serving call) still
    serves a later training step's backward."""
    with torch.inference_mode():
        resize.bilinear_resize(torch.ones(1, 1, 7, 9), 14, 18)
    x = torch.ones(1, 1, 7, 9, requires_grad=True)
    resize.bilinear_resize(x, 14, 18).sum().backward()
    assert torch.allclose(x.grad.sum(), torch.tensor(14.0 * 18.0))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("src,dst", [((125, 240), (250, 480)), ((125, 240), (500, 960))])
def test_backward_repeats_its_bits_on_the_card(cuda, src, dst):
    """The segmentation heads' two resizes at B=8: two backward passes of
    the same cotangent give the same bits, and match the CPU's."""
    x = _x(src, seed=6, batch=8)
    g = torch.from_numpy(np.random.default_rng(7).normal(size=(8, 1, *dst)).astype(np.float32))
    grads = []
    for _ in range(2):
        xt = torch.from_numpy(x).to(cuda).requires_grad_(True)
        resize.bilinear_resize(xt, *dst).backward(g.to(cuda))
        grads.append(xt.grad.cpu())
    assert torch.equal(grads[0], grads[1])
    xc = torch.from_numpy(x).requires_grad_(True)
    resize.bilinear_resize(xc, *dst).backward(g)
    assert _rel(grads[0].numpy(), xc.grad.numpy()) <= TOL
