"""The fused whole-Swin-block kernels: their wrappers, their plain versions,
the differentiable entry point and the build (port of
`swinwnet_tpu/ops/pallas/swin_block.py`).

Three entry points keep the JAX entry points' operands and layouts
(N = 25 tokens per window, Wt windows; LN parameters, biases and rel_bias
[nH, N, N] in fp32; x and the four weight matrices in the compute dtype):

* `fused_swin_block_cst`: x [C, N, Wt]; wqkv_t [3C, C], w1_t [4C, C] and
  w2_t [C, 4C] are [out, in]; wproj_t is [in, out] (the JAX name is kept for
  positional symmetry); pad_mask [N, Wt] marks real token slots.
* `fused_swin_block`: x [Wt*N, C] row-major tokens; every weight [in, out];
  pad_mask [Wt*N, 1]. qkv stays fp32 into the scores and values.
* `fused_swin_block_wide`: x [N, Wt, C]; every weight [in, out]; no mask.

Any strides of x are taken, and each weight may be dense in either order (a
contiguous matrix or the transposed view of one, as `nn.Linear.weight.t()`
is), so no caller copies or relays out an operand.

On a CUDA tensor a wrapper launches the hand-written kernel in
`csrc/swin_block.cu` (built with nvcc on first use, loaded with ctypes) or
raises; on a CPU tensor it runs its plain version. It returns a new tensor
in x's layout and does not write x.

`fused_block_autodiff` is the entry point the models call: the forward is
the kernel of the layout, the backward differentiates `swin_block_reference`
(plain fp32, no cast points), as the JAX package's `custom_vjp` does.
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
                [I, I, P, L, L, L, P, L, L, L, P, L, L]
                + [P] * 13
                + [I] * 7
                + [P]
            )
            lib.swin_block_launch.restype = I
            _lib = lib
    return _lib


def _ln(x32, s, b):
    return F.layer_norm(x32, (x32.shape[-1],), s, b, 1e-5)


def _block_math(
    x32, mask, ln1_s, ln1_b, wqkv, bqkv, rel_bias, wproj, bproj, ln2_s, ln2_b,
    w1, b1, w2, b2, num_heads: int, dt: torch.dtype, round_qkv: bool,
):
    """One block over fp32 windows x32 [Wt, N, C] with every weight [in, out]
    and mask [Wt, N, 1] or None; returns fp32 [Wt, N, C]. Values feeding a
    product are rounded to `dt` (qkv only when `round_qkv`), products and
    everything else are fp32. With dt = float32 nothing is rounded."""

    def r(t):  # round to the compute dtype, keep fp32
        return t.to(dt).float()

    Wt, N, C = x32.shape
    nH = num_heads
    hd = C // nH
    y = _ln(x32, ln1_s, ln1_b)
    if mask is not None:
        y = y * mask.float()
    qkv = r(y) @ wqkv.float() + bqkv  # [Wt, N, 3C]
    if round_qkv:
        qkv = r(qkv)
    q, k, v = (qkv[..., i * C:(i + 1) * C].reshape(Wt, N, nH, hd).transpose(1, 2) for i in range(3))
    attn = (q @ k.transpose(-1, -2)) * (hd ** -0.5) + rel_bias
    attn = torch.softmax(attn, dim=-1)
    o = (attn @ v).transpose(1, 2).reshape(Wt, N, C)
    x32 = x32 + r(o) @ wproj.float() + bproj
    y2 = _ln(x32, ln2_s, ln2_b)
    h = F.gelu(r(y2) @ w1.float() + b1)
    return x32 + r(h) @ w2.float() + b2


def swin_block_plain(
    x, ln1_s, ln1_b, wqkv_t, bqkv, rel_bias, wproj_t, bproj, ln2_s, ln2_b,
    w1_t, b1, w2_t, b2, num_heads: int, pad_mask: Optional[torch.Tensor] = None,
):
    """`fused_swin_block_cst` in plain PyTorch, with its cast points.
    Returns [C, N, Wt] in x.dtype."""
    mask = None if pad_mask is None else pad_mask.t().unsqueeze(-1)
    out = _block_math(
        x.permute(2, 1, 0).float(), mask, ln1_s, ln1_b, wqkv_t.t(), bqkv, rel_bias, wproj_t, bproj,
        ln2_s, ln2_b, w1_t.t(), b1, w2_t.t(), b2, num_heads, x.dtype, True,
    )
    return out.to(x.dtype).permute(2, 1, 0)


def swin_block_rowmajor_plain(
    x, ln1_s, ln1_b, wqkv, bqkv, rel_bias, wproj, bproj, ln2_s, ln2_b,
    w1, b1, w2, b2, num_heads: int, window_tokens: int = WINDOW_TOKENS,
    pad_mask: Optional[torch.Tensor] = None,
):
    """`fused_swin_block` in plain PyTorch, with its cast points (qkv is not
    rounded). Returns [Wt*N, C] in x.dtype."""
    N = window_tokens
    mask = None if pad_mask is None else pad_mask.reshape(-1, N, 1)
    out = _block_math(
        x.reshape(-1, N, x.shape[-1]).float(), mask, ln1_s, ln1_b, wqkv, bqkv, rel_bias, wproj, bproj,
        ln2_s, ln2_b, w1, b1, w2, b2, num_heads, x.dtype, False,
    )
    return out.to(x.dtype).reshape(x.shape)


def swin_block_wide_plain(
    x, ln1_s, ln1_b, wqkv, bqkv, rel_bias, wproj, bproj, ln2_s, ln2_b,
    w1, b1, w2, b2, num_heads: int,
):
    """`fused_swin_block_wide` in plain PyTorch, with its cast points.
    Returns [N, Wt, C] in x.dtype."""
    out = _block_math(
        x.transpose(0, 1).float(), None, ln1_s, ln1_b, wqkv, bqkv, rel_bias, wproj, bproj,
        ln2_s, ln2_b, w1, b1, w2, b2, num_heads, x.dtype, True,
    )
    return out.to(x.dtype).transpose(0, 1)


def swin_block_reference(
    x, ln1_s, ln1_b, wqkv, bqkv, rel_bias, wproj, bproj, ln2_s, ln2_b,
    w1, b1, w2, b2, num_heads: int, window_tokens: int = WINDOW_TOKENS,
    pad_mask: Optional[torch.Tensor] = None,
):
    """The block in plain fp32 with no cast points, in the row-major form
    (x [Wt*N, C], weights [in, out], pad_mask [Wt*N, 1]): what the
    differentiable entry point differentiates. Returns fp32 [Wt*N, C]."""
    N = window_tokens
    mask = None if pad_mask is None else pad_mask.reshape(-1, N, 1)
    out = _block_math(
        x.reshape(-1, N, x.shape[-1]).float(), mask, ln1_s, ln1_b, wqkv, bqkv, rel_bias, wproj, bproj,
        ln2_s, ln2_b, w1, b1, w2, b2, num_heads, torch.float32, False,
    )
    return out.reshape(x.shape)


_WEIGHT_NAMES = {True: ("wqkv_t", "wproj_t", "w1_t", "w2_t"), False: ("wqkv", "wproj", "w1", "w2")}


def _check(x_cnw, mask_nw, weights_oi, fp32_params, num_heads, cst: bool):
    """Operand checks shared by the three entry points, on their common
    views: x [C, N, Wt], mask [N, Wt], weights as [out, in]."""
    C, N, Wt = x_cnw.shape
    if x_cnw.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be float32 or bfloat16, got {x_cnw.dtype}")
    if C % num_heads:
        raise ValueError(f"C={C} must be a multiple of num_heads={num_heads}")
    H = 4 * C
    shapes = ((3 * C, C), (C, C), (H, C), (C, H))
    for name, want, w in zip(_WEIGHT_NAMES[cst], shapes, weights_oi):
        if tuple(w.shape) != want or w.dtype != x_cnw.dtype:
            shown = want if cst and name != "wproj_t" else want[::-1]
            raise ValueError(f"{name} must be a {shown} {x_cnw.dtype} tensor")
    lens = {"ln1_s": C, "ln1_b": C, "bqkv": 3 * C, "bproj": C, "ln2_s": C, "ln2_b": C, "b1": H, "b2": C}
    for (name, n), t in zip(lens.items(), fp32_params[:-1]):
        if tuple(t.shape) != (n,) or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous ({n},) float32 tensor")
    rel_bias = fp32_params[-1]
    if tuple(rel_bias.shape) != (num_heads, N, N) or rel_bias.dtype != torch.float32 or not rel_bias.is_contiguous():
        raise ValueError(f"rel_bias must be a contiguous ({num_heads}, {N}, {N}) float32 tensor")
    if mask_nw is not None and (tuple(mask_nw.shape) != (N, Wt) or mask_nw.dtype != torch.float32):
        raise ValueError(f"pad_mask must be a float32 tensor of {N} x {Wt} token slots")
    tensors = [x_cnw, *weights_oi, *fp32_params] + ([mask_nw] if mask_nw is not None else [])
    if any(t.device != x_cnw.device for t in tensors):
        raise ValueError("every operand must be on x's device")


def _weight_order(w_oi: torch.Tensor, name: str) -> int:
    """1 when the [out, in] view is row-contiguous, 0 when its transpose is;
    raises on any other strides."""
    o, i = w_oi.shape
    if w_oi.stride() == (i, 1):
        return 1
    if w_oi.stride() == (1, o):
        return 0
    raise ValueError(f"{name} must be a dense matrix or the transposed view of one, got strides {w_oi.stride()}")


def _launch(entry, x_cnw, out_cnw, mask_nw, weights_oi, fp32_params, num_heads, round_qkv, cst):
    """Launch the CUDA kernel on the [C, N, Wt] views and count it on `entry`."""
    C, N, Wt = x_cnw.shape
    if x_cnw.device.type != "cuda":
        raise ValueError(f"no kernel for device {x_cnw.device}")
    if N != WINDOW_TOKENS:
        raise ValueError(f"the kernel takes windows of {WINDOW_TOKENS} tokens, got {N}")
    if C % 4:
        raise ValueError(f"the kernel takes C a multiple of 4, got {C}")
    if any(w.data_ptr() % 16 for w in weights_oi):
        raise ValueError("the kernel's weights must be 16-byte aligned")
    orders = [_weight_order(w, name) for w, name in zip(weights_oi, _WEIGHT_NAMES[cst])]
    lib = _load()
    mask_ptr, smn, smw = None, 0, 0
    if mask_nw is not None:
        mask_ptr, (smn, smw) = mask_nw.data_ptr(), mask_nw.stride()
    ln1_s, ln1_b, bqkv, bproj, ln2_s, ln2_b, b1, b2, rel_bias = fp32_params
    wqkv, wproj, w1, w2 = weights_oi
    with torch.cuda.device(x_cnw.device):
        stream = torch.cuda.current_stream(x_cnw.device).cuda_stream
        err = lib.swin_block_launch(
            1 if x_cnw.dtype == torch.bfloat16 else 0, int(round_qkv),
            x_cnw.data_ptr(), *x_cnw.stride(), out_cnw.data_ptr(), *out_cnw.stride(),
            mask_ptr, smn, smw,
            ln1_s.data_ptr(), ln1_b.data_ptr(), wqkv.data_ptr(), bqkv.data_ptr(),
            rel_bias.data_ptr(), wproj.data_ptr(), bproj.data_ptr(),
            ln2_s.data_ptr(), ln2_b.data_ptr(), w1.data_ptr(), b1.data_ptr(),
            w2.data_ptr(), b2.data_ptr(),
            *orders, C, num_heads, Wt, stream,
        )
    if err != 0:
        raise RuntimeError(f"swin_block_launch failed with code {err} (C={C}, nH={num_heads}, Wt={Wt})")
    entry.launches += 1


def fused_swin_block_cst(
    x, ln1_s, ln1_b, wqkv_t, bqkv, rel_bias, wproj_t, bproj, ln2_s, ln2_b,
    w1_t, b1, w2_t, b2, num_heads: int, pad_mask: Optional[torch.Tensor] = None,
):
    """One Swin block over the [C, N, Wt] windows of x (see the module
    docstring). A CUDA x launches the kernel on the current stream and adds
    one to `fused_swin_block_cst.launches`; a CPU x runs `swin_block_plain`
    and adds one to `fused_swin_block_cst.plain_calls`."""
    weights_oi = (wqkv_t, wproj_t.t(), w1_t, w2_t)
    fp32_params = (ln1_s, ln1_b, bqkv, bproj, ln2_s, ln2_b, b1, b2, rel_bias)
    _check(x, pad_mask, weights_oi, fp32_params, num_heads, cst=True)
    if x.device.type == "cpu":
        fused_swin_block_cst.plain_calls += 1
        return swin_block_plain(
            x, ln1_s, ln1_b, wqkv_t, bqkv, rel_bias, wproj_t, bproj, ln2_s, ln2_b,
            w1_t, b1, w2_t, b2, num_heads, pad_mask,
        )
    out = torch.empty_like(x)  # same strides as x (dense, non-overlapping views)
    _launch(fused_swin_block_cst, x, out, pad_mask, weights_oi, fp32_params, num_heads, True, True)
    return out


def fused_swin_block(
    x, ln1_s, ln1_b, wqkv, bqkv, rel_bias, wproj, bproj, ln2_s, ln2_b,
    w1, b1, w2, b2, num_heads: int, window_tokens: int = WINDOW_TOKENS,
    pad_mask: Optional[torch.Tensor] = None,
):
    """One Swin block over row-major tokens x [Wt*N, C], weights [in, out],
    pad_mask [Wt*N, 1]. A CUDA x launches the kernel (qkv kept fp32) and adds
    one to `fused_swin_block.launches`; a CPU x runs
    `swin_block_rowmajor_plain` and adds one to `fused_swin_block.plain_calls`."""
    N = window_tokens
    if x.dim() != 2 or x.shape[0] % N:
        raise ValueError(f"x must be [Wt*{N}, C], got {tuple(x.shape)}")
    Wt = x.shape[0] // N
    if pad_mask is not None and tuple(pad_mask.shape) != (Wt * N, 1):
        raise ValueError(f"pad_mask must be a ({Wt * N}, 1) float32 tensor")
    as_cnw = lambda t: t.unflatten(0, (Wt, N)).permute(2, 1, 0)
    mask_nw = None if pad_mask is None else as_cnw(pad_mask)[0]
    weights_oi = (wqkv.t(), wproj.t(), w1.t(), w2.t())
    fp32_params = (ln1_s, ln1_b, bqkv, bproj, ln2_s, ln2_b, b1, b2, rel_bias)
    _check(as_cnw(x), mask_nw, weights_oi, fp32_params, num_heads, cst=False)
    if x.device.type == "cpu":
        fused_swin_block.plain_calls += 1
        return swin_block_rowmajor_plain(
            x, ln1_s, ln1_b, wqkv, bqkv, rel_bias, wproj, bproj, ln2_s, ln2_b,
            w1, b1, w2, b2, num_heads, N, pad_mask,
        )
    out = torch.empty_like(x)
    _launch(fused_swin_block, as_cnw(x), as_cnw(out), mask_nw, weights_oi, fp32_params, num_heads, False, False)
    return out


def fused_swin_block_wide(
    x, ln1_s, ln1_b, wqkv, bqkv, rel_bias, wproj, bproj, ln2_s, ln2_b,
    w1, b1, w2, b2, num_heads: int,
):
    """One Swin block over token-slot-major windows x [N, Wt, C], weights
    [in, out], no mask. A CUDA x launches the kernel and adds one to
    `fused_swin_block_wide.launches`; a CPU x runs `swin_block_wide_plain`
    and adds one to `fused_swin_block_wide.plain_calls`."""
    if x.dim() != 3:
        raise ValueError(f"x must be [N, Wt, C], got {tuple(x.shape)}")
    weights_oi = (wqkv.t(), wproj.t(), w1.t(), w2.t())
    fp32_params = (ln1_s, ln1_b, bqkv, bproj, ln2_s, ln2_b, b1, b2, rel_bias)
    _check(x.permute(2, 0, 1), None, weights_oi, fp32_params, num_heads, cst=False)
    if x.device.type == "cpu":
        fused_swin_block_wide.plain_calls += 1
        return swin_block_wide_plain(
            x, ln1_s, ln1_b, wqkv, bqkv, rel_bias, wproj, bproj, ln2_s, ln2_b,
            w1, b1, w2, b2, num_heads,
        )
    out = torch.empty_like(x)
    _launch(fused_swin_block_wide, x.permute(2, 0, 1), out.permute(2, 0, 1), None, weights_oi,
            fp32_params, num_heads, True, False)
    return out


KERNELS = (fused_swin_block_cst, fused_swin_block, fused_swin_block_wide)


def reset_counts() -> None:
    for entry in KERNELS:
        entry.launches = 0
        entry.plain_calls = 0


reset_counts()


# ---------------------------------------------------------------------------
# The differentiable entry point: kernel forward, plain fp32 backward
# ---------------------------------------------------------------------------

LAYOUTS = ("cmajor", "rowmajor", "nmajor")


def _kernel_call(layout: str, num_heads: int, x, mask, *weights):
    if layout == "cmajor":
        return fused_swin_block_cst(x, *weights, num_heads=num_heads, pad_mask=mask)
    if layout == "nmajor":
        if mask is not None:
            raise ValueError("the nmajor kernel takes no pad mask")
        return fused_swin_block_wide(x, *weights, num_heads=num_heads)
    if layout == "rowmajor":
        return fused_swin_block(x, *weights, num_heads=num_heads, pad_mask=mask)
    raise ValueError(f"layout must be one of {LAYOUTS}, got {layout!r}")


def _layout_reference(layout: str, num_heads: int, x, mask, *weights):
    """`swin_block_reference` for any layout: x, mask and weights go to the
    row-major form and the fp32 output comes back in x's layout."""
    N = WINDOW_TOKENS
    weights = list(weights)
    if layout == "cmajor":
        C, _, Wt = x.shape
        x2 = x.permute(2, 1, 0).reshape(Wt * N, C)
        m2 = None if mask is None else mask.t().reshape(-1, 1)
        for i in (2, 9, 11):  # wqkv, w1, w2 arrive [out, in] on this path
            weights[i] = weights[i].t()
        out = swin_block_reference(x2, *weights, num_heads=num_heads, pad_mask=m2)
        return out.reshape(Wt, N, C).permute(2, 1, 0)
    if layout == "nmajor":
        _, Wt, C = x.shape
        x2 = x.transpose(0, 1).reshape(Wt * N, C)
        out = swin_block_reference(x2, *weights, num_heads=num_heads)
        return out.reshape(Wt, N, C).transpose(0, 1)
    return swin_block_reference(x, *weights, num_heads=num_heads, pad_mask=mask)


class _FusedBlock(torch.autograd.Function):
    @staticmethod
    def forward(ctx, layout, num_heads, x, mask, *weights):
        ctx.layout, ctx.num_heads = layout, num_heads
        ctx.save_for_backward(x, mask, *weights)
        return _kernel_call(layout, num_heads, x, mask, *weights)

    @staticmethod
    def backward(ctx, g):
        x, mask, *weights = ctx.saved_tensors
        with torch.enable_grad():
            primals = [t.detach().requires_grad_(True) for t in (x, *weights)]
            out = _layout_reference(ctx.layout, ctx.num_heads, primals[0], mask, *primals[1:])
            needed = [i for i, need in enumerate((ctx.needs_input_grad[2], *ctx.needs_input_grad[4:])) if need]
            got = torch.autograd.grad(out, [primals[i] for i in needed], g.float())
        grads = [None] * len(primals)
        for i, gi in zip(needed, got):
            grads[i] = gi.to(primals[i].dtype)
        return (None, None, grads[0], None, *grads[1:])


def fused_block_autodiff(layout: str, num_heads: int, x, mask, *weights):
    """One Swin block, differentiable. `layout` is "cmajor" (x [C, N, Wt],
    mask [N, Wt]), "rowmajor" (x [Wt*N, C], mask [Wt*N, 1]) or "nmajor"
    (x [N, Wt, C], no mask); `weights` are the 13 operands after x of that
    layout's entry point. The forward is that entry point (the kernel on a
    CUDA x). The backward recomputes `swin_block_reference` in fp32 and
    differentiates it: x's gradient comes back in x's dtype, each weight's
    in its own, none for the mask. It saves x, the mask and the weights, and
    nothing when no gradient is being recorded."""
    return _FusedBlock.apply(layout, num_heads, x, mask, *weights)
