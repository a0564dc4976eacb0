"""The port's convolution with a deterministic backward
(swinwnet_tpu_torch/ops/conv.py) against `F.conv2d` under autograd: on the
CPU its backward is the same `aten.convolution_backward` call, so the
forward and every gradient must have the same bits, for the configurations
the model uses (the patch embedding's strided and dilated 2x2, the heads'
3x3 and 1x1, the policy's 3x3, SSIM's bias-free 7x7). The weight gradient
the card takes, one product a kernel tap, against aten's at the same
configurations: fp32 sums of the same products in another order, 1e-5 of
the max. The flags it sets for the backward are put back. On the card
(marked `cuda`) two backward passes of the upscaling head's 3x3 at 500x960
give the same bits, and its weight gradient matches aten's at full fp32
(sums of 3.84 M products in another order: 1e-4 of the max)."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from swinwnet_tpu_torch.core.device import full_fp32
from swinwnet_tpu_torch.ops.conv import conv2d, deterministic_cudnn, weight_grad_taps

torch.set_num_threads(1)

# (x shape, weight shape, bias, stride, padding, dilation)
CASES = [
    ((2, 2, 20, 30), (12, 2, 2, 2), True, 2, 0, 1),
    ((2, 2, 40, 60), (12, 2, 2, 2), True, 4, 0, 2),
    ((2, 12, 10, 15), (6, 12, 3, 3), True, 1, 1, 1),
    ((2, 6, 10, 15), (1, 6, 1, 1), True, 1, 0, 1),
    ((3, 2, 9, 11), (8, 2, 3, 3), True, 1, 1, 1),
    ((10, 1, 16, 16), (1, 1, 7, 7), False, 1, 0, 1),
]


@pytest.mark.parametrize("xs,ws,bias,stride,padding,dilation", CASES)
def test_forward_and_gradients_have_the_bits_of_autograd(xs, ws, bias, stride, padding, dilation):
    rng = np.random.default_rng(0)
    x0 = torch.from_numpy(rng.normal(size=xs).astype(np.float32))
    w0 = torch.from_numpy(rng.normal(size=ws).astype(np.float32))
    b0 = torch.from_numpy(rng.normal(size=ws[0]).astype(np.float32)) if bias else None
    out_shape = F.conv2d(x0, w0, b0, stride=stride, padding=padding, dilation=dilation).shape
    g = torch.from_numpy(rng.normal(size=out_shape).astype(np.float32))
    outs, grads = [], []
    for f in (conv2d, F.conv2d):
        leaves = [t.clone().requires_grad_(True) for t in (x0, w0, b0) if t is not None]
        y = f(*leaves[:2], leaves[2] if bias else None, stride=stride, padding=padding, dilation=dilation)
        y.backward(g)
        outs.append(y.detach())
        grads.append([t.grad for t in leaves])
    assert torch.equal(outs[0], outs[1])
    for got, want in zip(*grads):
        assert torch.equal(got, want)


@pytest.mark.parametrize("xs,ws,bias,stride,padding,dilation", CASES)
def test_weight_grad_by_taps_matches_aten(xs, ws, bias, stride, padding, dilation):
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.normal(size=xs).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=ws).astype(np.float32))
    out_shape = F.conv2d(x, w, stride=stride, padding=padding, dilation=dilation).shape
    g = torch.from_numpy(rng.normal(size=out_shape).astype(np.float32))
    want = torch.ops.aten.convolution_backward(g, x, w, None, [stride] * 2, [padding] * 2, [dilation] * 2, False,
                                               [0, 0], 1, [False, True, False])[1]
    got = weight_grad_taps(x, g, ws[2:], [stride] * 2, [padding] * 2, [dilation] * 2)
    assert got.shape == want.shape
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()


def test_only_the_inputs_that_need_it_get_a_gradient():
    x = torch.ones(1, 2, 6, 6, requires_grad=True)
    w, b = torch.ones(3, 2, 3, 3), torch.ones(3)
    conv2d(x, w, b, padding=1).sum().backward()
    assert x.grad is not None and x.grad.shape == x.shape


def test_flags_are_put_back():
    before = torch.backends.cudnn.deterministic
    with deterministic_cudnn():
        assert torch.backends.cudnn.deterministic
    assert torch.backends.cudnn.deterministic == before
    x = torch.ones(1, 1, 5, 5, requires_grad=True)
    conv2d(x, torch.ones(1, 1, 3, 3, requires_grad=True)).sum().backward()
    assert torch.backends.cudnn.deterministic == before


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_backward_repeats_its_bits_on_the_card(cuda):
    """The upscaling head's 3x3 (12 channels) at 500x960, B=8."""
    gen = torch.Generator().manual_seed(0)
    x0 = torch.randn(8, 12, 500, 960, generator=gen).to(cuda)
    w0 = torch.randn(12, 12, 3, 3, generator=gen).to(cuda)
    b0 = torch.randn(12, generator=gen).to(cuda)
    g = torch.randn(8, 12, 500, 960, generator=gen).to(cuda)
    grads = []
    for _ in range(2):
        leaves = [t.clone().requires_grad_(True) for t in (x0, w0, b0)]
        conv2d(*leaves, padding=1).backward(g)
        grads.append([t.grad.cpu() for t in leaves])
    for a, b in zip(*grads):
        assert torch.equal(a, b)
    with deterministic_cudnn(), full_fp32():  # the reference at full fp32 too: cuDNN's default is TF32
        want = torch.ops.aten.convolution_backward(g, x0, w0, [12], [1, 1], [1, 1], [1, 1], False, [0, 0], 1,
                                                   [False, True, True])
    for got, ref in zip(grads[0][1:], want[1:]):
        assert (got - ref.cpu()).abs().max() <= 1e-4 * ref.abs().max().item()
