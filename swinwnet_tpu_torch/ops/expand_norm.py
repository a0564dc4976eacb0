"""PatchExpanding's pixel shuffle and LayerNorm as one kernel: its wrapper
and its plain version (`csrc/expand_norm.cu`, which replaces no TPU kernel:
see its note).

`patch_expand_norm(y, ln, dtype)` takes the expand linear's output y
[B, H, W, 2C] in the compute dtype and returns the LayerNorm `ln` (C/2 wide)
of its pixel shuffle, [B, 2H, 2W, C/2] in that dtype:
out[b, 2h + p1, 2w + p2] = LN(y[b, h, w, k C/2 : (k + 1) C/2]), k = 2 p1 + p2,
with fp32 statistics (eps 1e-5) and affine step and one rounding.

On a CUDA tensor it launches the kernel on the current stream (built with
nvcc on first use, loaded with ctypes) and adds one to
`patch_expand_norm.launches`, which a program of `core.graphs` adds again on
every replay of a graph that captured it; it raises on what the kernel does
not take. On a CPU tensor it runs `patch_expand_norm_plain`: the shuffle's
copy and `models/layers.py` `layer_norm`, the composition that
`PatchExpanding` runs outside `torch.inference_mode`.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path

import torch
from torch import nn

from ..core.graphs import count_launches_of
from .swin_block import build

_SRC = Path(__file__).resolve().parent / "csrc" / "expand_norm.cu"
_lib = None
_lib_lock = threading.Lock()


def _load():
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build(src=_SRC)))
            P, L, I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
            lib.expand_norm_launch.argtypes = [I, P, P, P, P, L, I, I, P]
            lib.expand_norm_launch.restype = I
            _lib = lib
    return _lib


def patch_expand_norm_plain(y: torch.Tensor, ln: nn.LayerNorm, dtype: torch.dtype) -> torch.Tensor:
    """The shuffle's copy, then `layer_norm` (the cast to fp32, torch's
    LayerNorm and the cast back): what the kernel computes, in four passes."""
    from ..models.layers import layer_norm  # models.layers imports this module

    B, H, W, C2 = y.shape
    x = y.reshape(B, H, W, 2, 2, C2 // 4).permute(0, 1, 3, 2, 4, 5).reshape(B, 2 * H, 2 * W, C2 // 4)
    return layer_norm(x, ln, dtype)


def patch_expand_norm(y: torch.Tensor, ln: nn.LayerNorm, dtype: torch.dtype) -> torch.Tensor:
    """LN(pixel_shuffle(y)) (see the module docstring)."""
    c = ln.normalized_shape[0]
    if y.dim() != 4 or len(ln.normalized_shape) != 1 or y.shape[3] != 4 * c:
        raise ValueError(f"y must be [B, H, W, {4 * c}] for a LayerNorm of {tuple(ln.normalized_shape)}, "
                         f"got {tuple(y.shape)}")
    if y.device.type == "cpu":
        return patch_expand_norm_plain(y, ln, dtype)
    if y.device.type != "cuda":
        raise ValueError(f"no kernel for device {y.device}")
    if dtype not in (torch.bfloat16, torch.float32) or y.dtype != dtype:
        raise ValueError(f"the kernel takes y in the compute dtype, bfloat16 or float32: got {y.dtype} for {dtype}")
    if not y.is_contiguous():
        raise ValueError("the kernel takes a contiguous y")
    for name, t in (("weight", ln.weight), ("bias", ln.bias)):
        if t is None or tuple(t.shape) != (c,) or t.dtype != torch.float32 or not t.is_contiguous() \
                or t.device != y.device:
            raise ValueError(f"the LayerNorm's {name} must be a contiguous ({c},) float32 tensor on y's device")
    B, H, W, _ = y.shape
    out = torch.empty((B, 2 * H, 2 * W, c), dtype=dtype, device=y.device)
    if out.numel() == 0:
        return out
    lib = _load()
    with torch.cuda.device(y.device):
        stream = torch.cuda.current_stream(y.device).cuda_stream
        err = lib.expand_norm_launch(1 if dtype == torch.bfloat16 else 0, y.data_ptr(), out.data_ptr(),
                                     ln.weight.data_ptr(), ln.bias.data_ptr(), B * H * W, W, c, stream)
    if err != 0:
        raise RuntimeError(f"expand_norm_launch failed with code {err} (y {tuple(y.shape)}, {dtype})")
    patch_expand_norm.launches += 1
    return out


patch_expand_norm.launches = 0
count_launches_of(patch_expand_norm)
