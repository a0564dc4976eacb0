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
in x's layout and does not write x. Every CUDA call a launch makes
(cudaFuncSetAttribute, the device's SM count, the occupancy calculator,
the launch) is allowed under CUDA-graph capture, so a program of
`core.graphs` captures it, and adds the launches it captured to `launches`
on every replay.

`fused_block_autodiff` is the entry point the models call: the forward is
the kernel of the layout, the backward differentiates `swin_block_reference`
(plain fp32, no cast points), as the JAX package's `custom_vjp` does.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from ..core.device import full_fp32
from ..core.graphs import Counter, count_launches_of

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


def build(verbose: bool = False, defines: tuple = (), src: Path = _SRC) -> Path:
    """Compile `src` (csrc/swin_block.cu, or another source of csrc/) into
    BUILD_DIR (keyed by the hash of the source and the flags) unless that
    library exists; returns its path. `defines` are preprocessor names, e.g.
    ("SWIN_BLOCK_PHASES",)."""
    flags = (*NVCC_FLAGS, *(f"-D{d}" for d in defines))
    key = hashlib.sha1(src.read_bytes() + " ".join(flags).encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"lib{src.stem}_{key}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *flags, *(["-Xptxas", "-v"] if verbose else []), "-o", str(tmp), str(src)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr}")
    if verbose:
        print(res.stderr, end="")
    os.replace(tmp, lib)
    return lib


def bind(path: Path):
    """The built library at `path`, with swin_block_launch's signature set."""
    lib = ctypes.CDLL(str(path))
    P, L, I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.swin_block_launch.argtypes = (
        [I, I, P, L, L, L, P, L, L, L, P, L, L]
        + [P] * 13
        + [I] * 21
        + [P]
    )
    lib.swin_block_launch.restype = I
    lib.swin_block_info.argtypes = [I] * 10 + [ctypes.POINTER(I)] * 2
    lib.swin_block_info.restype = I
    lib.swin_block_erf_check.argtypes = [P, P]
    lib.swin_block_erf_check.restype = I
    return lib


def _load():
    global _lib
    with _lib_lock:
        if _lib is None:
            _lib = bind(build())
    return _lib


SMEM_MAX = 232448  # bytes of shared memory a CTA can opt in to on sm_90 (227 KB)
_THREADS = 256  # a CTA's threads: the kernel's __launch_bounds__, 255 registers each
_ROWS_TARGET = 9600  # M * C a CTA aims at: two [M, C] fp32 buffers of ~38 KB
_MAX_WB = 8  # at most 200 rows a CTA


class KernelPlan(NamedTuple):
    """How one CTA of the Swin-block kernel is cut (see csrc/swin_block.cu)."""

    WB: int  # windows a CTA: M = 25 * WB rows (the narrow body: windows a warp's unit)
    G: int  # heads per qkv/attention group (the narrow body: all heads)
    HC: int  # MLP hidden columns per chunk
    KC: int  # k extent of a staged weight tile (the fp32-FMA body; the narrow body: an mma tile's, 16)
    OT: int  # output columns of a staged weight tile (the fp32-FMA body; the narrow body: an mma tile's, 8)
    # output columns a thread holds, its register tile 5 x CN (the Hopper body: its widest product, 48 or 96;
    # the narrow body: the head width, which with C names its instance)
    CN: int
    threads: int
    smem_bytes: int
    lda: int  # row stride of the two [M, C] buffers, floats (the Hopper body: of A1 and A2, bf16 elements; narrow: C)
    # row stride of the qkv / hidden chunk, floats (the Hopper body: of its q|k|v rows, bf16 elements; the
    # narrow body: a head's columns padded to a multiple of 8)
    ldq: int
    offsets: tuple  # byte offsets of ys, os, the chunk and the weight ring
    # (the Hopper body: of the fp32 parameters, the rel-pos bias, two window stages, A1, A2, the chunk, the weights;
    # the narrow body: of the fp32 parameters, the rel-pos bias and the warps' stages, the weights at 0)
    body: int = 0  # 0: the fp32-FMA body; 1: the Hopper body (wgmma, TMA, warp-specialised); 2: the narrow body
    mp: int = 0  # the Hopper body: rows a batch padded to 64 (the narrow body: a window's 25 rows padded to 32)
    min_ctas: int = 1  # CTAs an SM the plan counts on (the Hopper body: 1 or 2; the narrow body: 2)
    # the Hopper body: consumer warpgroups (rows / 64), weight ring
    # slots (0: all weights resident), qkv parts per head group (1, or 3 when
    # a group's q|k|v is wider than the body holds), and the swizzle spans:
    # (A1 and A2, the hidden chunk, then [out, in] and [in, out] weights of
    # qkv, proj, fc1 and fc2)
    nwg: int = 0
    ring: int = 0
    parts: int = 1
    spans: tuple = ()
    variant: int = 0  # the instance that fixes this shape's widths (hopper_variant), 0: read at run time


def _smem_layout(C, hd, WB, G, HC, KC, OT, itemsize):
    """(bytes, lda, ldq, offsets) of a plan, as the kernel lays it out: two
    [M, C + 4] fp32 buffers, the [M, max(3 * G * hd, HC) + 4] fp32 chunk, two
    stages of OT x (KC + 16 bytes) weights in the compute type."""
    M = WINDOW_TOKENS * WB
    lda, ldq = C + 4, max(3 * G * hd, HC) + 4
    stage = OT * (KC + 16 // itemsize)
    offsets = (0, 4 * M * lda, 8 * M * lda, 4 * M * (2 * lda + ldq))
    return offsets[-1] + 2 * stage * itemsize, lda, ldq, offsets


# bytes of shared memory a CTA may take for two to share an SM's 228 KB (1 KB each reserved)
SMEM_TWO_CTAS = 115712
MMA_MAX_C = 96  # the widest bf16 level the Hopper body takes (the bf16 gate's cap)


def _round_up(n, m):
    return -(-n // m) * m


def _odd_units(n):
    """The least bf16 row stride >= n that is an odd number of 16-byte units."""
    n = _round_up(n, 8)
    return n if (n // 8) % 2 else n + 8


# ---------------------------------------------------------------------------
# The Hopper body's plan and its shared-memory layout, mirroring h_layout,
# h_job, tile_off and window_map in csrc/swin_block.cu
# ---------------------------------------------------------------------------

H_ALIGN = 1024  # operand buffers start on the 128-byte swizzle's period
H_MAX_RING = 8  # weight ring slots at most


def swizzle(off: int, span: int) -> int:
    """The byte offset `off` after the span-byte swizzle (TMA's SWIZZLE_32B,
    64B, 128B; wgmma's layout types 3, 2, 1): its 16-byte unit index XOR
    the 128-byte row index, as many bits as the span has units past the
    first."""
    return off ^ (((off >> 7) & (span // 16 - 1)) << 4)


def tile_offset(row: int, col: int, rows: int, span: int) -> int:
    """Byte offset of bf16 element (row, col) of a tile of `rows` rows whose
    contiguous dimension is col, kept as blocks of `span` bytes of every row
    (block b holds columns b * span / 2 .., a row at `span` bytes), swizzled:
    what TMA writes for a box {span / 2, rows} and wgmma reads through a
    descriptor with SBO = 8 * span."""
    b = 2 * col
    return swizzle((b // span) * rows * span + row * span + b % span, span)


def span_of(nbytes: int) -> int:
    """The widest swizzle span that divides a row of `nbytes` (a multiple of 32)."""
    return 128 if nbytes % 128 == 0 else 64 if nbytes % 64 == 0 else 32


def hopper_jobs(C, num_heads, G, HC, parts):
    """The products of a window batch in the Hopper body, in order, as
    (weight, K, O, run): nH/G head groups of qkv (in `parts` of q, k, v
    each when 3), proj, then fc1 and fc2 per hidden chunk; `run` is the
    length of a run of consecutive stored output columns."""
    GD = G * (C // num_heads)
    qkv = [("qkv", C, 3 * GD, GD)] if parts == 1 else [("qkv", C, GD, GD)] * 3
    mlp = [("fc1", C, HC, HC), ("fc2", HC, C, C)] * (4 * C // HC)
    return qkv * (num_heads // G) + [("proj", C, C, C)] + mlp


def hopper_weight_bytes(K, O, oi: bool) -> int:
    """Bytes of a product's weights: [out, in] storage as the K-major
    [round8(O)][round16(K)], [in, out] as the MN-major [round16(K)][round16(O)]."""
    return 2 * _round_up(K, 16) * (_round_up(O, 8) if oi else _round_up(O, 16))


def hopper_weight_span(K, O, oi: bool) -> int:
    return span_of(2 * (_round_up(K, 16) if oi else _round_up(O, 16)))


def _hopper_layout(C, num_heads, WB, G, HC, parts, mp, ring):
    """(bytes, ldq, offsets) of a Hopper plan as h_layout lays it out from a
    1024-aligned base: the mbarriers, the fp32 parameters, the rel-pos bias,
    two window stages, A1, A2, the chunk (q|k|v rows of ldq, or the [mp, HC] hidden
    chunk), and the weights: every product's (ring 0) or `ring` slots of the
    largest."""
    M, Kpc = WINDOW_TOKENS * WB, _round_up(C, 16)
    ldq = _odd_units(3 * G * (C // num_heads))
    chunk_rows = _round_up(max(mp, M + 7), 8)
    a = lambda n: _round_up(n, H_ALIGN)
    sizes = [H_ALIGN, a(13 * C * 4), a(num_heads * WINDOW_TOKENS ** 2 * 4), a(M * C * 2), a(M * C * 2),
             a(mp * Kpc * 2), a(mp * Kpc * 2), a(max(chunk_rows * ldq * 2, mp * HC * 2))]
    offsets = tuple(sum(sizes[:i]) for i in range(len(sizes) + 1))[1:]  # parameters .. weights
    slots = [a(max(hopper_weight_bytes(K, O, True), hopper_weight_bytes(K, O, False)))
             for _, K, O, _ in hopper_jobs(C, num_heads, G, HC, parts)]
    weights = ring * max(slots) if ring else sum(slots)
    return H_ALIGN + offsets[-1] + weights, ldq, offsets


def _hopper_heads(C, num_heads, HC, maxn, streamed):
    """(G, parts): the widest head group whose q|k|v the chunk holds (3 G hd
    <= max(HC, 3 hd)) in one product of at most maxn columns, else in three
    of G hd each; streamed weights need G hd a multiple of 16 (TMA boxes)."""
    hd = C // num_heads
    heads = [g for g in range(1, num_heads + 1) if num_heads % g == 0 and (not streamed or g * hd % 16 == 0)]
    one = [g for g in heads if 3 * g * hd <= min(max(HC, 3 * hd), maxn)]
    if one:
        return max(one), 1
    three = [g for g in heads if g * hd <= maxn and 3 * g * hd <= max(HC, 3 * hd)]
    if three:
        return max(three), 3
    raise ValueError(f"no head group of the Hopper body at C={C}, num_heads={num_heads}")


# the Hopper body's instances with fixed widths, as hopper_instance in the
# .cu builds them: (C, a qkv product's output columns, HC) -> variant; one
# for each bf16 serving level's width above NARROW_MAX_C
HOPPER_VARIANTS = {(48, 48, 48): 3, (96, 96, 96): 4}


def hopper_variant(C, num_heads, G, HC, parts) -> int:
    GD = G * (C // num_heads)
    return HOPPER_VARIANTS.get((C, 3 * GD if parts == 1 else GD, HC), 0)


def _hopper_plan(C, num_heads):
    """The Hopper body's plan: 125 rows a batch in two consumer warpgroups of
    64 (WB = 5), or 250 in four (WB = 10) where a batch of 5 windows is not a
    whole number of 16-byte units; the widest hidden chunk of a multiple of
    16 up to max(C, 48); weights resident at C <= 48, else a ring of as many
    slots as shared memory holds; two CTAs an SM where they fit."""
    maxn = 48 if C <= 48 else 96
    WB = 5 if (5 * C) % 8 == 0 else 10
    mp = _round_up(WINDOW_TOKENS * WB, 64)
    nwg = mp // 64
    HC = max(h for h in range(16, 4 * C + 1, 16) if (4 * C) % h == 0 and h <= max(C, 48))
    streamed = C > 48
    G, parts = _hopper_heads(C, num_heads, HC, maxn, streamed)
    ring = 0
    if streamed:
        fits = [r for r in range(2, H_MAX_RING + 1)
                if _hopper_layout(C, num_heads, WB, G, HC, parts, mp, r)[0] <= SMEM_MAX]
        if not fits:
            raise ValueError(f"no weight ring of the Hopper body fits at C={C}, num_heads={num_heads}")
        ring = max(fits)
    nbytes, ldq, offsets = _hopper_layout(C, num_heads, WB, G, HC, parts, mp, ring)
    if nbytes > SMEM_MAX:
        raise ValueError(f"the Hopper body does not fit shared memory at C={C}, num_heads={num_heads}")
    ctas = 2 if maxn == 48 and nwg == 2 and nbytes <= SMEM_TWO_CTAS else 1
    Kpc = _round_up(C, 16)
    first = {}
    for w, K, O, _ in hopper_jobs(C, num_heads, G, HC, parts):
        first.setdefault(w, (K, O))
    spans = (span_of(2 * Kpc), span_of(2 * HC)) + tuple(
        hopper_weight_span(*first[w], oi) for w in ("qkv", "proj", "fc1", "fc2") for oi in (True, False))
    return KernelPlan(WB, G, HC, 16, 8, maxn, nwg * 128 + 64, nbytes, Kpc, ldq, offsets, 1, mp, ctas,
                      nwg, ring, parts, spans, hopper_variant(C, num_heads, G, HC, parts))


# ---------------------------------------------------------------------------
# The narrow body's plan and its shared-memory layout, mirroring NShape and
# narrow_instance in csrc/swin_block.cu
# ---------------------------------------------------------------------------

NARROW_MAX_C = 24  # the widest bf16 level the narrow body takes (C = 12 and 24 serve)
NARROW_THREADS = 256  # 8 warps a CTA, each owning whole windows
NARROW_STAGES = 3  # units a warp holds: the one it computes and the next two in flight
# (C, head width) of every instance NB_SHAPES in the .cu builds: each width
# up to NARROW_MAX_C with each head width (a multiple of 4) that divides it
NARROW_SHAPES = tuple((C, hd) for C in range(4, NARROW_MAX_C + 1, 4) for hd in range(4, C + 1, 4) if C % hd == 0)


def narrow_tiles(C, num_heads):
    """The narrow body's 16-row attention tiles a window: two a head, or,
    with heads of at most 8 columns and 3 or 4 of them (NShape::PACK), one
    a head for its rows 0-15 and the heads' rows 16-24 packed two halves a
    tile (each head's rows 16-23, then row 24 of every head)."""
    packed = C // num_heads <= 8 and 3 <= num_heads <= 4
    return num_heads + (num_heads + 2) // 2 if packed else 2 * num_heads


def _narrow_layout(C, num_heads):
    """(bytes, offsets) of the narrow body's shared memory, as NShape lays it
    out: the weights as mma B fragments (qkv, proj, fc1, fc2: 256 bytes a
    16 x 8 tile), the fp32 parameters, the rel-pos bias as accumulator
    fragments (2 KB an attention tile), then each warp's stages of a unit's
    windows and their pad-mask values. Offsets: parameters, rel-pos bias,
    stages."""
    hd = C // num_heads
    HT = -(-hd // 8)
    NT, KT, U, NC = -(-C // 8), -(-C // 16), num_heads * HT, C // 4
    WPW = 2 if C % 8 else 1
    frags = KT * 3 * U + -(-U // 2) * NT + KT * 2 * NC + NC * NT
    par = _round_up(4 * (48 * NT + 24 * U + 4 * C), 16)
    stage = _round_up(WPW * WINDOW_TOKENS * C * 2, 16) + _round_up(WPW * WINDOW_TOKENS * 4, 16)
    off_par = 256 * frags
    offsets = (off_par, off_par + par, off_par + par + narrow_tiles(C, num_heads) * 2048)
    return offsets[-1] + (NARROW_THREADS // 32) * NARROW_STAGES * stage, offsets


def _narrow_plan(C, num_heads):
    """The narrow body's plan: a warp owns whole windows, WB = 1 or 2 a unit
    (two where one window's 50 C bytes are not a whole number of 16-byte
    units), products on mma.sync m16n8k16 tiles (25 rows padded to 32, each
    head's columns padded to a multiple of 8), weights resident, two CTAs
    of 256 threads an SM."""
    hd = C // num_heads
    if (C, hd) not in NARROW_SHAPES:
        raise ValueError(f"no instance of the narrow body at C={C}, num_heads={num_heads}")
    nbytes, offsets = _narrow_layout(C, num_heads)
    if nbytes > SMEM_TWO_CTAS:
        raise ValueError(f"the narrow body does not fit two CTAs an SM at C={C}, num_heads={num_heads}")
    return KernelPlan(2 if C % 8 else 1, num_heads, 16, 16, 8, hd, NARROW_THREADS, nbytes, C, 8 * -(-hd // 8),
                      offsets, 2, 32, 2)


def io_route(t, WB: int) -> int:
    """How the Hopper body moves the [C, N, Wt] view t's windows, as
    window_map in the .cu checks it: 2 a TMA box [WB][N][C] (channels
    contiguous, windows outermost), 3 a box [N][WB][C] (token slots
    outermost), 4 a box [N][WB * C] (a window's channels right after the
    last window's), 1 one bulk copy of the batch's contiguous bytes, 0
    element by element (any other strides)."""
    C, N, Wt = t.shape
    sc, sn, sw = t.stride()
    if t.data_ptr() % 16 == 0 and sc == 1:
        if C % 8 == 0 and sn % 8 == 0 and sw % 8 == 0:
            if sn >= C and sw >= N * sn:
                return 2
            if sw >= C and sn >= Wt * sw:
                return 3
        if sw == C and (WB * C) % 8 == 0 and WB * C <= 256 and sn % 8 == 0 and sn >= Wt * C:
            return 4
        if sn == C and sw == N * C and (WB * N * C) % 8 == 0:
            return 1
    return 0


@functools.lru_cache(maxsize=None)
def kernel_plan(C: int, num_heads: int, dtype: torch.dtype, round_qkv: bool = True) -> KernelPlan:
    """The kernel's plan for width C. bf16 with qkv rounded (the cst and wide
    entries) takes the narrow body at C <= 24 (`_narrow_plan`) and the
    Hopper body above, up to C = 96 (`_hopper_plan`). Any other
    launch takes the fp32-FMA body: as many windows a CTA as keep M * C near
    9600 elements (4 at C = 96, 2 at C = 192, 1 from C = 384), an output tile
    OT that gives every thread one 5 x CN register tile (5 * WB * OT / CN <=
    threads) and cuts C in equal parts, the head group and the hidden chunk
    no wider than OT, and the deepest weight tile that fits. Raises when
    nothing fits the 227 KB of shared memory."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"no kernel for {dtype}")
    if C <= 0 or C % num_heads or (C // num_heads) % 4:
        raise ValueError(f"the kernel takes a head width that is a multiple of 4, got C={C}, num_heads={num_heads}")
    if dtype == torch.bfloat16 and round_qkv and C <= NARROW_MAX_C:
        return _narrow_plan(C, num_heads)
    if dtype == torch.bfloat16 and round_qkv and (C <= 48 or (C <= MMA_MAX_C and C % 16 == 0)):
        return _hopper_plan(C, num_heads)
    itemsize = 4 if dtype == torch.float32 else 2
    hd = C // num_heads
    threads = _THREADS
    for WB in range(max(1, min(_MAX_WB, _ROWS_TARGET // (WINDOW_TOKENS * C))), 0, -1):
        row_groups = 5 * WB
        for CN in (8, 4):
            cap = CN * (threads // row_groups) // 8 * 8  # widest tile one round of threads covers
            parts = -(-C // cap)  # output tiles that cut C
            OT = min(-(-C // (8 * parts)) * 8, cap)
            # a narrow width leaves most threads without a tile at 8 columns each
            if row_groups * (OT // CN) * 2 >= threads:
                break
        G = max(g for g in range(1, num_heads + 1) if num_heads % g == 0 and (g == 1 or 3 * g * hd <= OT))
        HC = max(h for h in range(4, 4 * C + 1, 4) if (4 * C) % h == 0 and (h <= OT or h == 4))
        for KC in (32, 16, 8):
            nbytes, lda, ldq, offsets = _smem_layout(C, hd, WB, G, HC, KC, OT, itemsize)
            if nbytes <= SMEM_MAX:
                return KernelPlan(WB, G, HC, KC, OT, CN, threads, nbytes, lda, ldq, offsets)
    raise ValueError(f"no plan of the Swin-block kernel fits shared memory at C={C}, num_heads={num_heads}")


def kernel_info(C: int, num_heads: int, dtype: torch.dtype, round_qkv: bool = True, lib=None):
    """(registers a thread, CTAs an SM) of the kernel instance that the plan
    of (C, num_heads, dtype, round_qkv) launches, from the built library
    (`lib`, else the one the wrappers use); needs a CUDA device."""
    plan = kernel_plan(C, num_heads, dtype, round_qkv)
    lib = lib or _load()
    regs, ctas = ctypes.c_int(0), ctypes.c_int(0)
    err = lib.swin_block_info(int(dtype == torch.bfloat16), int(round_qkv), C, num_heads, plan.body, plan.min_ctas, plan.CN,
                              plan.threads, plan.smem_bytes, plan.variant, ctypes.byref(regs), ctypes.byref(ctas))
    if err != 0:
        raise RuntimeError(f"swin_block_info failed with code {err} (C={C}, nH={num_heads})")
    return regs.value, ctas.value


def _ln(x32, s, b):
    return F.layer_norm(x32, (x32.shape[-1],), s, b, 1e-5)


@full_fp32()
def _block_math(
    x32, mask, ln1_s, ln1_b, wqkv, bqkv, rel_bias, wproj, bproj, ln2_s, ln2_b,
    w1, b1, w2, b2, num_heads: int, dt: torch.dtype, round_qkv: bool,
):
    """One block over fp32 windows x32 [Wt, N, C] with every weight [in, out]
    and mask [Wt, N, 1] or None; returns fp32 [Wt, N, C]. Values feeding a
    product are rounded to `dt` (qkv only when `round_qkv`), products and
    everything else are fp32, at full fp32. With dt = float32 nothing is
    rounded."""

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
    plan = kernel_plan(C, num_heads, x_cnw.dtype, round_qkv)
    if any(t.data_ptr() % 16 for t in (*weights_oi, *fp32_params)):
        raise ValueError("the kernel's weights and fp32 parameters must be 16-byte aligned")
    orders = [_weight_order(w, name) for w, name in zip(weights_oi, _WEIGHT_NAMES[cst])]
    io = (io_route(x_cnw, plan.WB), io_route(out_cnw, plan.WB)) if plan.body == 1 else (0, 0)
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
            *orders, C, num_heads, Wt,
            plan.WB, plan.G, plan.HC, plan.KC, plan.OT, plan.CN, plan.threads, plan.smem_bytes, plan.body,
            plan.min_ctas, plan.ring, plan.parts, *io, stream,
        )
    if err != 0:
        raise RuntimeError(f"swin_block_launch failed with code {err} (C={C}, nH={num_heads}, Wt={Wt})")
    entry.launches += 1
    if plan.body == 2:
        NARROW_LAUNCHES.launches += 1


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
count_launches_of(*KERNELS)
# launches of the narrow body (through the cst or wide entry), besides the entry's own count
NARROW_LAUNCHES = Counter("swin_block_narrow")


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
