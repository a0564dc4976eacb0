"""A 2-D convolution whose backward gives the same bits on every run.

cuDNN picks its backward algorithms by heuristics, and some of them (the
weight gradient's, in the upscaling head's 3x3 convolution at 500x960 on the
H100) sum partial products with atomic adds in whatever order the threads
arrive. `conv2d` is `F.conv2d` forward. Its backward computes the input's
gradient with the same `aten.convolution_backward` autograd would call, run
with cuDNN's `deterministic` flag set for the call. On the card the weight's
gradient is one product a kernel tap (`weight_grad_taps`), which cuBLAS
sums in a fixed order: cuDNN's deterministic weight-gradient algorithm is
several times slower there (`scripts/determinism_cost.py` times the three
ways). On the CPU, whose backward is deterministic already, it stays
`aten.convolution_backward`'s. In fp32 the backward runs at full fp32 (TF32
off), as the forward does under `core.device.full_fp32`. The flags are put
back after the call: nothing is switched on for the process.
"""

from __future__ import annotations

import contextlib
from typing import Iterator, Optional, Sequence

import torch
import torch.nn.functional as F
from torch.nn.modules.utils import _pair

from ..core.device import full_fp32


@contextlib.contextmanager
def deterministic_cudnn() -> Iterator[None]:
    """cuDNN restricted to deterministic algorithms for the block."""
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = saved


def weight_grad_taps(x: torch.Tensor, grad: torch.Tensor, kernel: Sequence[int], stride: Sequence[int],
                     padding: Sequence[int], dilation: Sequence[int]) -> torch.Tensor:
    """The gradient of an ungrouped convolution's [O, I, kh, kw] weight: for
    each kernel tap, grad [B, O, Ho, Wo] against the input window that tap
    reads, [B, I, Ho, Wo], as one product over B * Ho * Wo."""
    (kh, kw), (sh, sw), (ph, pw), (dh, dw) = kernel, stride, padding, dilation
    B, I = x.shape[:2]
    O, Ho, Wo = grad.shape[1:]
    xp = F.pad(x, (pw, pw, ph, ph))
    g = grad.transpose(0, 1).reshape(O, B * Ho * Wo)
    out = x.new_empty(O, I, kh, kw)
    for i in range(kh):
        for j in range(kw):
            window = xp[:, :, i * dh:i * dh + sh * (Ho - 1) + 1:sh, j * dw:j * dw + sw * (Wo - 1) + 1:sw]
            out[:, :, i, j] = g @ window.transpose(0, 1).reshape(I, B * Ho * Wo).t()
    return out


class _Conv2d(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias, stride, padding, dilation, groups):
        ctx.save_for_backward(x, weight)
        ctx.conf = (bias is not None, stride, padding, dilation, groups)
        return F.conv2d(x, weight, bias, stride, padding, dilation, groups)

    @staticmethod
    def backward(ctx, grad):
        x, weight = ctx.saved_tensors
        has_bias, stride, padding, dilation, groups = ctx.conf
        need_x, need_w, need_b = ctx.needs_input_grad[:3]
        taps = grad.is_cuda and groups == 1 and need_w
        mask = [need_x, need_w and not taps, has_bias and need_b and not taps]
        gx = gw = gb = None
        with deterministic_cudnn(), full_fp32(grad.dtype):
            if any(mask):
                gx, gw, gb = torch.ops.aten.convolution_backward(
                    grad, x, weight, [weight.shape[0]] if has_bias else None, stride, padding, dilation, False,
                    [0, 0], groups, mask)
            if taps:
                gw = weight_grad_taps(x, grad, weight.shape[2:], stride, padding, dilation)
                if has_bias and need_b:
                    gb = grad.sum((0, 2, 3))
        return gx, gw, gb, None, None, None, None


def conv2d(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor] = None, stride=1, padding=0,
           dilation=1, groups: int = 1) -> torch.Tensor:
    """`F.conv2d` (integer padding) with a deterministic backward."""
    return _Conv2d.apply(x, weight, bias, list(_pair(stride)), list(_pair(padding)), list(_pair(dilation)), groups)
