"""The unfused levels' window attention as one kernel in bf16 serving: its
wrapper and its plain version (`csrc/window_attention.cu`, which replaces no
TPU kernel: see its note).

`window_attention(qkv, bias, num_heads, dtype)` takes the qkv linear's output
qkv [Bw, N, 3C] (channel s C + h hd + d for s = q, k, v) and the
relative-position bias [nH, N, N] in fp32, and returns the heads' outputs
[Bw, N, C] in `dtype`, as `out.transpose(1, 2).reshape(Bw, N, C)` lays them
out for the output projection: `window_attention_plain`'s arithmetic up to
the order of the fp32 sums.

On a CUDA tensor it launches the kernel on the current stream (built with
nvcc on first use, loaded with ctypes) and adds one to
`window_attention.launches`, which a program of `core.graphs` adds again on
every replay of a graph that captured it; it raises on what the kernel does
not take (a shape outside `takes`, not bf16, a qkv not contiguous and
16-byte aligned). On a CPU tensor
it runs `window_attention_plain`, the chain that `WindowAttention._attend`
runs everywhere the kernel is not taken.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import Callable, Optional

import torch

from ..core.device import full_fp32
from ..core.graphs import count_launches_of
from .swin_block import build

_SRC = Path(__file__).resolve().parent / "csrc" / "window_attention.cu"
_lib = None
_lib_lock = threading.Lock()

# the kernel's plan (`plan_of` in csrc/window_attention.cu, which the card tests
# hold `takes` to): a unit is a window's heads in groups of at most UNIT_MAX
# channels, and its CTA's WARPS warps take whole units
HEAD_WIDTHS = (16, 32)
UNIT_MAX = 192
WARPS = 12
MAX_TOKENS = 32


def takes(C: int, num_heads: int, N: int) -> bool:
    """Whether the kernel takes windows of N tokens, C channels and
    `num_heads` heads: a head width of 16 or 32, N <= 32, and C in groups of
    U = min(C, 192) channels whose heads divide the CTA's 12 warps."""
    if num_heads < 1 or C % num_heads or not 1 <= N <= MAX_TOKENS:
        return False
    hd, unit = C // num_heads, min(C, UNIT_MAX)
    return hd in HEAD_WIDTHS and C % unit == 0 and unit % hd == 0 and WARPS % (unit // hd) == 0


def _load():
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build(src=_SRC)))
            P, L, I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
            lib.window_attention_launch.argtypes = [P, P, P, L, I, I, I, ctypes.c_float, P]
            lib.window_attention_launch.restype = I
            lib.window_attention_plan.argtypes = [I, I, I, P]
            lib.window_attention_plan.restype = I
            _lib = lib
    return _lib


def window_attention_plain(qkv: torch.Tensor, bias: torch.Tensor, num_heads: int, dtype: torch.dtype,
                           mask: Optional[torch.Tensor] = None,
                           drop: Optional[Callable[[torch.Tensor], torch.Tensor]] = None) -> torch.Tensor:
    """The heads' outputs [Bw, N, C] in `dtype` from qkv [Bw, N, 3C]: q times
    hd^-0.5 in `dtype`, scores in fp32 from operands in `dtype` plus the fp32
    `bias` (and a shifted level's `mask` [nW, N, N]), the softmax in fp32,
    the probabilities in `dtype` (then `drop`, the attention dropout), P.V
    in fp32 rounded to `dtype`."""
    Bw, N, C3 = qkv.shape
    C = C3 // 3
    hd = C // num_heads
    qkv = qkv.reshape(Bw, N, 3, num_heads, hd).permute(2, 0, 3, 1, 4)
    q, k, v = qkv[0] * torch.tensor(hd ** -0.5, dtype=dtype), qkv[1], qkv[2]
    with full_fp32(dtype):
        attn = q.float() @ k.float().transpose(-1, -2) + bias
        if mask is not None:  # [nW, N, N] onto [B, nW, nH, N, N]
            nW = mask.shape[0]
            attn = (attn.reshape(Bw // nW, nW, num_heads, N, N) + mask[None, :, None]).reshape(Bw, num_heads, N, N)
        attn = torch.softmax(attn, dim=-1).to(dtype)
        if drop is not None:
            attn = drop(attn)
        out = (attn.float() @ v.float()).to(dtype)  # [Bw, nH, N, hd]
    return out.transpose(1, 2).reshape(Bw, N, C)


def window_attention(qkv: torch.Tensor, bias: torch.Tensor, num_heads: int, dtype: torch.dtype) -> torch.Tensor:
    """The heads' outputs of windows' attention (see the module docstring)."""
    if qkv.dim() != 3 or qkv.shape[2] % 3:
        raise ValueError(f"qkv must be [Bw, N, 3C], got {tuple(qkv.shape)}")
    Bw, N, C3 = qkv.shape
    C = C3 // 3
    if tuple(bias.shape) != (num_heads, N, N):
        raise ValueError(f"bias must be [{num_heads}, {N}, {N}], got {tuple(bias.shape)}")
    if qkv.device.type == "cpu":
        return window_attention_plain(qkv, bias, num_heads, dtype)
    if qkv.device.type != "cuda":
        raise ValueError(f"no kernel for device {qkv.device}")
    if dtype != torch.bfloat16 or qkv.dtype != dtype:
        raise ValueError(f"the kernel takes qkv in bfloat16: got {qkv.dtype} for {dtype}")
    if not qkv.is_contiguous() or qkv.data_ptr() % 16:
        raise ValueError("the kernel takes a contiguous, 16-byte aligned qkv")
    if bias.dtype != torch.float32 or not bias.is_contiguous() or bias.device != qkv.device:
        raise ValueError("the bias must be a contiguous float32 tensor on qkv's device")
    out = torch.empty((Bw, N, C), dtype=dtype, device=qkv.device)
    if Bw == 0:
        return out
    scale = float(torch.tensor(max(C // num_heads, 1) ** -0.5, dtype=dtype))  # the plain version's q scale
    lib = _load()
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream(qkv.device).cuda_stream
        err = lib.window_attention_launch(qkv.data_ptr(), out.data_ptr(), bias.data_ptr(), Bw, N, C, num_heads,
                                          scale, stream)
    if err == -1:
        raise ValueError(f"no kernel for {N} tokens, C = {C} and {num_heads} heads (head widths {HEAD_WIDTHS}, "
                         f"at most {MAX_TOKENS} tokens)")
    if err != 0:
        raise RuntimeError(f"window_attention_launch failed with code {err} (qkv {tuple(qkv.shape)}, "
                           f"{num_heads} heads)")
    window_attention.launches += 1
    return out


window_attention.launches = 0
count_launches_of(window_attention)
