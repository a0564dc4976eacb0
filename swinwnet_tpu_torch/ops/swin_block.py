"""The fused whole-Swin-block kernel: its wrapper, its plain version and its
build (port of `swinwnet_tpu/ops/pallas/swin_block.py:fused_swin_block_cst`).

`fused_swin_block_cst` keeps the JAX entry point's signature: x is a
[C, N, Wt] view of Wt windows of N = 25 tokens; wqkv_t [3C, C], w1_t [4C, C]
and w2_t [C, 4C] are [out, in]; wproj_t is [in, out] (the JAX name is kept
for positional symmetry); LN parameters, biases and rel_bias [nH, N, N] are
fp32; pad_mask [N, Wt] marks real token slots. Any strides of x are taken,
so callers pass the channels-major array of the JAX package or a permuted
view of the token-major [Wt, N, C] windows alike.

On a CUDA tensor the wrapper launches the hand-written kernel in
`csrc/swin_block.cu` (built with nvcc on first use, loaded with ctypes) or
raises; on a CPU tensor it runs `swin_block_plain`. It returns a new tensor
with the strides of x and does not write x.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import torch
import torch.nn.functional as F

WINDOW_TOKENS = 25

_SRC = Path(__file__).resolve().parent / "csrc" / "swin_block.cu"
BUILD_DIR = Path(__file__).resolve().parent / "csrc" / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

_lib = None
_lib_lock = threading.Lock()


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME) to build the Swin-block kernel")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def build(verbose: bool = False) -> Path:
    """Compile csrc/swin_block.cu into BUILD_DIR (keyed by the source's hash)
    unless that library exists; returns its path."""
    src = _SRC.read_bytes()
    key = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"libswin_block_{key}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []), "-o", str(tmp), str(_SRC)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr}")
    if verbose:
        print(res.stderr, end="")
    os.replace(tmp, lib)
    return lib


def _load():
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            P, L, I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
            lib.swin_block_launch.argtypes = (
                [I, P, L, L, L, P, L, L, L, P, L, L]
                + [P] * 13
                + [I, I, I, P]
            )
            lib.swin_block_launch.restype = I
            _lib = lib
    return _lib


def _ln(x32, s, b):
    return F.layer_norm(x32, (x32.shape[-1],), s, b, 1e-5)


def swin_block_plain(
    x, ln1_s, ln1_b, wqkv_t, bqkv, rel_bias, wproj_t, bproj, ln2_s, ln2_b,
    w1_t, b1, w2_t, b2, num_heads: int, pad_mask: Optional[torch.Tensor] = None,
):
    """The kernel's function in plain PyTorch, with its cast points: values
    feeding a product are rounded to x.dtype, products and everything else
    are fp32. Returns [C, N, Wt] in x.dtype."""
    dt = x.dtype

    def r(t):  # round to the compute dtype, keep fp32
        return t.to(dt).float()

    C, N, Wt = x.shape
    nH = num_heads
    hd = C // nH
    x32 = x.permute(2, 1, 0).float()  # [Wt, N, C]
    y = _ln(x32, ln1_s, ln1_b)
    if pad_mask is not None:
        y = y * pad_mask.t().unsqueeze(-1).float()
    qkv = r(r(y) @ wqkv_t.float().t() + bqkv)  # [Wt, N, 3C]
    q, k, v = (qkv[..., i * C:(i + 1) * C].reshape(Wt, N, nH, hd).transpose(1, 2) for i in range(3))
    attn = (q @ k.transpose(-1, -2)) * (hd ** -0.5) + rel_bias
    attn = torch.softmax(attn, dim=-1)
    o = (attn @ v).transpose(1, 2).reshape(Wt, N, C)
    x32 = x32 + r(o) @ wproj_t.float() + bproj
    y2 = _ln(x32, ln2_s, ln2_b)
    h = F.gelu(r(y2) @ w1_t.float().t() + b1)
    x32 = x32 + r(h) @ w2_t.float().t() + b2
    return x32.to(dt).permute(2, 1, 0)


def _check(x, mask, weights, fp32_params, num_heads):
    C, N, Wt = x.shape
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if C % num_heads:
        raise ValueError(f"C={C} must be a multiple of num_heads={num_heads}")
    H = 4 * C
    shapes = {"wqkv_t": (3 * C, C), "wproj_t": (C, C), "w1_t": (H, C), "w2_t": (C, H)}
    for (name, want), w in zip(shapes.items(), weights):
        if tuple(w.shape) != want or w.dtype != x.dtype or not w.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {want} {x.dtype} tensor")
    lens = {"ln1_s": C, "ln1_b": C, "bqkv": 3 * C, "bproj": C, "ln2_s": C, "ln2_b": C, "b1": H, "b2": C}
    for (name, n), t in zip(lens.items(), fp32_params[:-1]):
        if tuple(t.shape) != (n,) or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous ({n},) float32 tensor")
    rel_bias = fp32_params[-1]
    if tuple(rel_bias.shape) != (num_heads, N, N) or rel_bias.dtype != torch.float32 or not rel_bias.is_contiguous():
        raise ValueError(f"rel_bias must be a contiguous ({num_heads}, {N}, {N}) float32 tensor")
    if mask is not None and (tuple(mask.shape) != (N, Wt) or mask.dtype != torch.float32):
        raise ValueError(f"pad_mask must be a ({N}, {Wt}) float32 tensor")
    tensors = [x, *weights, *fp32_params] + ([mask] if mask is not None else [])
    if any(t.device != x.device for t in tensors):
        raise ValueError("every operand must be on x's device")


def _check_kernel(x, weights):
    """What the CUDA kernel takes beyond the function itself."""
    C, N, _ = x.shape
    if N != WINDOW_TOKENS:
        raise ValueError(f"the kernel takes windows of {WINDOW_TOKENS} tokens, got {N}")
    if C % 4:
        raise ValueError(f"the kernel takes C a multiple of 4, got {C}")
    if any(w.data_ptr() % 16 for w in weights):
        raise ValueError("the kernel's weights must be 16-byte aligned")


def fused_swin_block_cst(
    x, ln1_s, ln1_b, wqkv_t, bqkv, rel_bias, wproj_t, bproj, ln2_s, ln2_b,
    w1_t, b1, w2_t, b2, num_heads: int, pad_mask: Optional[torch.Tensor] = None,
):
    """One Swin block over the [C, N, Wt] windows of x (see the module
    docstring). A CUDA x launches the kernel on the current stream and adds
    one to `fused_swin_block_cst.launches`; a CPU x runs `swin_block_plain`
    and adds one to `fused_swin_block_cst.plain_calls`."""
    weights = (wqkv_t, wproj_t, w1_t, w2_t)
    fp32_params = (ln1_s, ln1_b, bqkv, bproj, ln2_s, ln2_b, b1, b2, rel_bias)
    _check(x, pad_mask, weights, fp32_params, num_heads)
    if x.device.type == "cpu":
        fused_swin_block_cst.plain_calls += 1
        return swin_block_plain(
            x, ln1_s, ln1_b, wqkv_t, bqkv, rel_bias, wproj_t, bproj, ln2_s, ln2_b,
            w1_t, b1, w2_t, b2, num_heads, pad_mask,
        )
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    _check_kernel(x, weights)
    lib = _load()
    C, N, Wt = x.shape
    out = torch.empty_like(x)  # same strides as x (dense, non-overlapping views)
    mask_ptr, smn, smw = None, 0, 0
    if pad_mask is not None:
        mask_ptr, (smn, smw) = pad_mask.data_ptr(), pad_mask.stride()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.swin_block_launch(
            1 if x.dtype == torch.bfloat16 else 0,
            x.data_ptr(), *x.stride(), out.data_ptr(), *out.stride(),
            mask_ptr, smn, smw,
            ln1_s.data_ptr(), ln1_b.data_ptr(), wqkv_t.data_ptr(), bqkv.data_ptr(),
            rel_bias.data_ptr(), wproj_t.data_ptr(), bproj.data_ptr(),
            ln2_s.data_ptr(), ln2_b.data_ptr(), w1_t.data_ptr(), b1.data_ptr(),
            w2_t.data_ptr(), b2.data_ptr(),
            C, num_heads, Wt, stream,
        )
    if err != 0:
        raise RuntimeError(f"swin_block_launch failed with code {err} (C={C}, nH={num_heads}, Wt={Wt})")
    fused_swin_block_cst.launches += 1
    return out


fused_swin_block_cst.launches = 0
fused_swin_block_cst.plain_calls = 0


def reset_counts() -> None:
    fused_swin_block_cst.launches = 0
    fused_swin_block_cst.plain_calls = 0

