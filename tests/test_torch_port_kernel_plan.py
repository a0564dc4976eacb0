"""The Swin-block kernel's plan (`kernel_plan` in
swinwnet_tpu_torch/ops/swin_block.py): how a CTA is cut for a width, head
count and compute type. The CUDA launcher checks the same conditions and
refuses a plan that breaks one; here they are held without a card, for every
signature the three kernels meet on the serving and training paths and for
a few odd ones."""

import re

import pytest
import torch

from swinwnet_tpu_torch.ops.swin_block import (
    _SRC,
    H_ALIGN,
    H_MAX_RING,
    HOPPER_VARIANTS,
    NARROW_MAX_C,
    NARROW_SHAPES,
    NARROW_STAGES,
    NARROW_THREADS,
    SMEM_MAX,
    SMEM_TWO_CTAS,
    WINDOW_TOKENS,
    hopper_jobs,
    hopper_weight_bytes,
    io_route,
    kernel_plan,
    narrow_tiles,
    span_of,
    swizzle,
    tile_offset,
)

# (C, num_heads) of the on-path shapes: the channels-major kernel in serving,
# the row-major kernel in fp32 training with fused_deep, the wide kernel on
# the token-slot-major route
CST_LEVELS = [(48, 3), (96, 6), (96, 3), (24, 3), (12, 3)]
ROW_LEVELS = [(96, 6), (192, 12), (384, 24), (384, 12), (192, 6), (96, 3)]
WIDE_LEVELS = [(48, 3), (24, 3), (12, 3), (96, 3)]
ODD = [(4, 1), (12, 3), (384, 24), (768, 24)]
CASES = sorted(set(CST_LEVELS + ROW_LEVELS + WIDE_LEVELS + ODD))
DTYPES = [torch.float32, torch.bfloat16]


def _units16(n):
    """bf16 elements n as 16-byte units, asserting that they are whole."""
    assert n % 8 == 0
    return n // 8


def _check_narrow_plan(p, C, nH):
    """The narrow body's invariants (bf16, qkv rounded, C <= 24): the widths
    and heads it takes, a warp's windows as whole 16-byte units, two CTAs of
    8 warps an SM within shared memory and the registers, and the layout
    NShape makes."""
    hd = C // nH
    assert p.body == 2 and C <= NARROW_MAX_C and C % nH == 0 and hd % 4 == 0 and (C, hd) in NARROW_SHAPES
    assert p.CN == hd and p.G == nH and p.ldq == -(-hd // 8) * 8 and p.mp == 32 and p.lda == C
    # a unit of WB windows is a whole number of 16-byte units, and WB is the least that is
    assert (p.WB * WINDOW_TOKENS * C * 2) % 16 == 0 and (p.WB == 1 or (WINDOW_TOKENS * C * 2) % 16)
    # two CTAs of 8 warps an SM: 128 registers a thread (the launch bounds), shared memory for both
    assert p.threads == NARROW_THREADS == 256 and p.min_ctas == 2 and p.threads * p.min_ctas <= 2048
    assert p.min_ctas * p.threads * 128 <= 65536
    assert p.smem_bytes <= SMEM_TWO_CTAS <= SMEM_MAX
    # layout: weight fragments (a 16 x 8 bf16 tile, 256 bytes), parameters, rel-pos bias, stages
    HT, NT, KT, NC = -(-hd // 8), -(-C // 8), -(-C // 16), C // 4
    tiles = KT * 3 * nH * HT + -(-nH * HT // 2) * NT + KT * 2 * NC + NC * NT
    par, rel, st = p.offsets
    assert all(off % 16 == 0 for off in p.offsets) and par == 256 * tiles
    assert rel - par >= 4 * (6 * 8 * NT + 3 * nH * 8 * HT + 4 * C)  # six C-vectors, bqkv permuted, b1
    # [query tile][key tile] float4 a lane: two tiles a head, or packed (heads of 8 columns or fewer, 3 or 4
    # of them) one a head and ceil((nH + 1) / 2) for the heads' rows 16-24 (75 query rows in 5 tiles at nH = 3)
    tiles = nH + (nH + 2) // 2 if hd <= 8 and 3 <= nH <= 4 else 2 * nH
    assert narrow_tiles(C, nH) == tiles and 16 * tiles >= WINDOW_TOKENS * nH
    assert st - rel == tiles * 4 * 32 * 16
    stage = -(-p.WB * WINDOW_TOKENS * C * 2 // 16) * 16 + -(-p.WB * WINDOW_TOKENS * 4 // 16) * 16
    assert p.smem_bytes == st + (p.threads // 32) * NARROW_STAGES * stage


def _check_hopper_plan(p, C, nH):
    """The Hopper body's invariants (bf16, qkv rounded, 24 < C <= 96): 64-row
    tiles, 227 KB, weights resident at C <= 48, spans that divide each
    operand's row bytes, and the layout h_layout makes."""
    hd = C // nH
    M = WINDOW_TOKENS * p.WB
    maxn = 48 if C <= 48 else 96
    assert p.body == 1 and p.CN == maxn and C > NARROW_MAX_C
    # rows padded to a multiple of 64, one consumer warpgroup each, and a producer warp pair
    assert p.mp % 64 == 0 and M <= p.mp < M + 64 and p.nwg == p.mp // 64 and p.threads == 128 * p.nwg + 64
    # a batch's token-major windows are whole 16-byte units (one bulk copy)
    assert (2 * M * C) % 16 == 0
    assert p.smem_bytes <= SMEM_MAX
    assert p.min_ctas in (1, 2) and (p.min_ctas == 1 or p.smem_bytes <= SMEM_TWO_CTAS)
    if C <= 48:
        assert p.ring == 0  # all 12 C^2 weights resident
    else:
        assert C % 16 == 0 and 2 <= p.ring <= H_MAX_RING  # streamed through the ring
    # every product fits the instance's accumulators
    assert p.HC % 16 == 0 and (4 * C) % p.HC == 0 and p.HC <= maxn and -(-C // 8) * 8 <= maxn
    assert nH % p.G == 0 and p.parts in (1, 3)
    assert (3 if p.parts == 1 else 1) * p.G * hd <= maxn
    jobs = hopper_jobs(C, nH, p.G, p.HC, p.parts)
    assert len(jobs) == (nH // p.G) * p.parts + 1 + 2 * (4 * C // p.HC)
    assert sum(O for w, _, O, _ in jobs if w == "qkv") == 3 * C  # every head's q, k and v
    assert sum(O for w, _, O, _ in jobs if w == "fc1") == 4 * C == sum(K for w, K, _, _ in jobs if w == "fc2")
    # swizzle spans divide the row bytes: A1/A2 (C padded to 16), the hidden chunk, each weight either way
    Kpc = -(-C // 16) * 16
    assert p.lda == Kpc and (2 * Kpc) % p.spans[0] == 0 and (2 * p.HC) % p.spans[1] == 0
    first = {}
    for w, K, O, _ in jobs:
        first.setdefault(w, (K, O))
    for i, w in enumerate(("qkv", "proj", "fc1", "fc2")):
        K, O = first[w]
        span_oi, span_io = p.spans[2 + 2 * i:4 + 2 * i]
        assert (2 * (-(-K // 16) * 16)) % span_oi == 0 and (2 * (-(-O // 16) * 16)) % span_io == 0
        assert all(s in (32, 64, 128) for s in (span_oi, span_io))
    # the chunk's q|k|v rows: an odd number of 16-byte units (ldmatrix rows in distinct banks)
    assert p.ldq >= 3 * p.G * hd and _units16(p.ldq) % 2 == 1
    # layout: parameters, rel-pos bias, two stages, A1, A2, chunk, weights;
    # 1024-aligned, in order, no overlap
    par, rel, st0, st1, a1, a2, ch, wts = p.offsets
    assert all(off % H_ALIGN == 0 for off in p.offsets) and par == H_ALIGN
    assert rel - par >= 13 * C * 4 and st0 - rel >= nH * WINDOW_TOKENS ** 2 * 4
    assert st1 - st0 == a1 - st1 >= 2 * M * C
    assert a2 - a1 == ch - a2 >= 2 * p.mp * Kpc
    assert wts - ch >= max(2 * max(p.mp, M + 7) * p.ldq, 2 * p.mp * p.HC)
    slots = [-(-max(hopper_weight_bytes(K, O, True), hopper_weight_bytes(K, O, False)) // H_ALIGN) * H_ALIGN
             for _, K, O, _ in jobs]
    assert p.smem_bytes == H_ALIGN + wts + (p.ring * max(slots) if p.ring else sum(slots))


@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
@pytest.mark.parametrize("C,nH", CASES)
def test_plan_fits_the_card_and_the_kernel(C, nH, dtype):
    p = kernel_plan(C, nH, dtype)
    if dtype == torch.bfloat16 and C <= NARROW_MAX_C:
        _check_narrow_plan(p, C, nH)
        return
    if dtype == torch.bfloat16 and C <= 96:
        _check_hopper_plan(p, C, nH)
        return
    assert p.body == 0 and p.min_ctas == 1
    itemsize = 4 if dtype == torch.float32 else 2
    hd = C // nH
    assert p.WB >= 1 and WINDOW_TOKENS * p.WB <= 200
    assert p.smem_bytes <= SMEM_MAX
    assert nH % p.G == 0
    assert (4 * C) % p.HC == 0 and p.HC % 4 == 0
    assert p.KC % 8 == 0 and p.OT % 8 == 0 and p.CN in (4, 8)
    assert p.threads % 32 == 0 and p.threads <= 256  # the kernel's __launch_bounds__
    # one register tile a thread: every (row group, column group) has its thread
    assert 5 * p.WB * (p.OT // p.CN) <= p.threads
    assert p.KC in (8, 16, 32)
    # the chunk holds a head group's q|k|v and a hidden chunk
    assert p.ldq >= max(3 * p.G * hd, p.HC) and p.lda >= C
    # 16-byte loads: every buffer and every row starts on a multiple of 16 bytes
    assert all(off % 16 == 0 for off in p.offsets)
    assert (4 * p.lda) % 16 == 0 and (4 * p.ldq) % 16 == 0
    assert (p.smem_bytes - p.offsets[-1]) % (2 * 16) == 0
    # the buffers do not overlap and the ring holds two stages of either tile order
    M = WINDOW_TOKENS * p.WB
    assert p.offsets[1] - p.offsets[0] >= 4 * M * p.lda
    assert p.offsets[2] - p.offsets[1] >= 4 * M * p.lda
    assert p.offsets[3] - p.offsets[2] >= 4 * M * p.ldq
    stage = (p.smem_bytes - p.offsets[3]) // 2
    assert stage >= itemsize * p.KC * p.OT and stage >= p.OT * (itemsize * p.KC + 16)


@pytest.mark.parametrize("C,nH,min_wb", [(96, 3, 4), (96, 6, 4), (192, 6, 2), (192, 12, 2)])
def test_fp32_plan_takes_several_windows_a_cta(C, nH, min_wb):
    """What cuts the L2 -> SM weight traffic of the row-major training shapes."""
    assert kernel_plan(C, nH, torch.float32).WB >= min_wb


@pytest.mark.parametrize("C,nH", [(384, 12), (384, 24), (768, 24)])
def test_wide_levels_keep_no_full_width_qkv(C, nH):
    p = kernel_plan(C, nH, torch.float32)
    assert p.G < nH and 3 * p.G * (C // nH) <= p.OT


@pytest.mark.parametrize("C,nH,dtype,error", [
    (96, 48, torch.float32, ValueError),   # head width 2: the kernel reads heads in fours
    (90, 4, torch.float32, ValueError),    # heads do not divide C
    (96, 3, torch.float16, TypeError),
])
def test_plan_refuses_what_the_kernel_does_not_take(C, nH, dtype, error):
    with pytest.raises(error):
        kernel_plan(C, nH, dtype)


@pytest.mark.parametrize("round_qkv", [True, False], ids=["qkv-rounded", "qkv-fp32"])
@pytest.mark.parametrize("C,nH", CST_LEVELS + WIDE_LEVELS)
def test_bf16_serving_shapes_take_the_tensor_cores(C, nH, round_qkv):
    """cst and wide (qkv rounded) in bf16 take the narrow body at C <= 24
    and the Hopper body above; with qkv kept fp32 (the row-major entry) the
    same width takes the fp32-FMA body's plan, as in fp32 apart from the
    weights' type."""
    p = kernel_plan(C, nH, torch.bfloat16, round_qkv)
    if round_qkv and C <= NARROW_MAX_C:
        _check_narrow_plan(p, C, nH)
    elif round_qkv:
        _check_hopper_plan(p, C, nH)
    else:
        assert p.body == 0 and p.CN in (4, 8)
        assert (p.WB, p.G, p.HC, p.OT, p.CN) == kernel_plan(C, nH, torch.float32)[:2] + kernel_plan(
            C, nH, torch.float32)[2:3] + kernel_plan(C, nH, torch.float32)[4:6]
    assert kernel_plan(C, nH, torch.float32, round_qkv) == kernel_plan(C, nH, torch.float32)


@pytest.mark.parametrize("C,nH", [(56, 14), (72, 6), (88, 2)])
def test_bf16_plan_above_48_off_16_takes_the_fma_body(C, nH):
    """Above C = 48 the Hopper body streams its weights by TMA boxes, which
    need C a multiple of 16. Other bf16 widths above 48 (no level of the
    model) take the fp32-FMA body."""
    p = kernel_plan(C, nH, torch.bfloat16)
    assert p.body == 0 and p.min_ctas == 1 and p.CN in (4, 8)


# every (C, num_heads) the narrow body takes: C = 12 and 24 with 3 heads (the SR
# head's levels) and each other width up to 24 with each head width that divides it
NARROW_CASES = sorted((C, C // hd) for C, hd in NARROW_SHAPES)
# bf16 widths the Hopper body takes: the on-path levels above C = 24 and a
# spread of others (head widths 4 to 96, qkv in one product or in three parts)
HOPPER_CASES = sorted(set(CST_LEVELS + WIDE_LEVELS + [(32, 1), (32, 2), (36, 9), (40, 10), (44, 11), (48, 1),
                                                      (48, 12), (64, 4), (64, 16), (80, 5), (80, 20), (96, 1),
                                                      (96, 12), (96, 24)]) - set(NARROW_CASES))


@pytest.mark.parametrize("C,nH", HOPPER_CASES)
def test_hopper_plan_at_every_width_it_takes(C, nH):
    _check_hopper_plan(kernel_plan(C, nH, torch.bfloat16), C, nH)


@pytest.mark.parametrize("C,nH", NARROW_CASES)
def test_narrow_plan_at_every_width_it_takes(C, nH):
    _check_narrow_plan(kernel_plan(C, nH, torch.bfloat16), C, nH)


def test_narrow_body_takes_every_head_width_up_to_24():
    """Every bf16 (C, num_heads) up to C = 24 that the kernel takes (a head
    width that is a multiple of 4) has a narrow instance, and the .cu builds
    exactly those (NB_SHAPES), as the Python list names them."""
    want = {(C, hd) for C in range(4, NARROW_MAX_C + 1, 4) for hd in range(4, C + 1, 4) if C % hd == 0}
    assert set(NARROW_SHAPES) == want
    src = _SRC.read_text()
    macro = src[src.index("#define NB_SHAPES(X)"):].split("\n\n")[0]
    built = {(int(a), int(b)) for a, b in re.findall(r"X\((\d+), (\d+)\)", macro)}
    assert built == want


@pytest.mark.parametrize("C,nH,body", [(48, 3, 1), (96, 6, 1), (96, 3, 1), (48, 1, 1), (96, 24, 1),
                                       (32, 2, 1), (28, 7, 1), (24, 3, 2), (12, 3, 2), (4, 1, 2)])
@pytest.mark.parametrize("dtype,round_qkv", [(torch.bfloat16, True), (torch.bfloat16, False), (torch.float32, True)],
                         ids=["bf16-cst", "bf16-rowmajor", "fp32"])
def test_each_launch_takes_its_body(C, nH, body, dtype, round_qkv):
    """The route is chosen from C, the dtype and round_qkv alone: bf16 with
    qkv rounded takes the narrow body at C <= 24 and the Hopper body at C =
    28 to 96 (the fixed-width instances at 48 and 96 only); fp32 and the
    row-major entry's bf16 take the fp32-FMA body at every width."""
    p = kernel_plan(C, nH, dtype, round_qkv)
    if dtype == torch.float32 or not round_qkv:
        assert p.body == 0
        return
    assert p.body == body
    assert p.variant == {48: 3, 96: 4}.get(C, 0) if body == 1 else p.variant == 0
    assert set(HOPPER_VARIANTS.values()) == {3, 4} and all(c > NARROW_MAX_C for c, _, _ in HOPPER_VARIANTS)


@pytest.mark.parametrize("span,rows,cols", [
    (span, rows, cols) for span in (32, 64, 128)
    for rows, cols in [(8, 16), (40, 48), (64, 96), (128, 48), (96, 64), (256, 16), (128, 128)]
    if (2 * cols) % span == 0])
def test_swizzled_tile_is_a_bijection_onto_its_bytes(span, rows, cols):
    """tile_offset, the mirror of the kernel's tile_off, puts the elements of
    a rows x cols tile (cols whole spans) on distinct 2-byte slots that fill
    exactly its rows * cols * 2 bytes."""
    offs = {tile_offset(r, c, rows, span) for r in range(rows) for c in range(cols)}
    assert offs == set(range(0, 2 * rows * cols, 2))


@pytest.mark.parametrize("span", [32, 64, 128])
def test_swizzle_matches_the_span_formula(span):
    """Within a block, row r's 16-byte unit u lands at unit u ^ ((r * span /
    128) mod (span / 16)): CUTLASS's Swizzle<log2(span / 16), 4, 3>, the
    pattern of TMA's CU_TENSOR_MAP_SWIZZLE_<span>B; at 128 bytes, group ^
    (row % 8) as a 64-element row of bf16."""
    units = span // 16
    for r in range(16):
        for c in range(span // 2):
            u = (2 * c) // 16
            want = r * span + ((u ^ ((r * span >> 7) % units)) * 16) + (2 * c) % 16
            assert tile_offset(r, c, 16, span) == want
            if span == 128:
                assert tile_offset(r, c, 16, span) == r * 128 + 2 * (((c // 8) ^ (r % 8)) * 8 + c % 8)
    # a whole period of 8 rows maps onto itself, and the pattern repeats past it
    assert all(swizzle(o + 8 * span, span) == swizzle(o, span) + 8 * span for o in range(0, 8 * span, 16))


@pytest.mark.parametrize("nbytes,span", [(32, 32), (64, 64), (96, 32), (128, 128), (160, 32), (192, 64), (256, 128)])
def test_span_is_the_widest_that_divides_a_row(nbytes, span):
    assert span_of(nbytes) == span


@pytest.mark.parametrize("layout,C,Wt,want", [
    ("token-major", 96, 960, 2), ("token-major", 48, 15, 2), ("token-major", 24, 7, 2),
    ("token-major", 12, 100, 1),   # 24-byte rows: no box; 10 windows are whole 16-byte units
    ("slot-major", 96, 960, 3), ("slot-major", 48, 13, 3),
    ("slot-major", 12, 100, 4),    # a box of 10 windows' 12 channels, token slot by token slot
    ("slot-major", 12, 101, 0),    # odd rows of 12 channels: not whole 16-byte units
    ("channels-major", 48, 64, 0), ("channels-major", 12, 64, 0),
])
def test_io_route_of_each_layout(layout, C, Wt, want):
    """Which way the Hopper body moves the windows of each [C, N, Wt] view
    the entries give it."""
    N = WINDOW_TOKENS
    x = torch.zeros(N * Wt * C + 8, dtype=torch.bfloat16)
    base = x[(-x.data_ptr() % 16) // 2:][:N * Wt * C]  # 16-byte aligned
    if layout == "token-major":
        v = base.view(Wt, N, C).permute(2, 1, 0)
    elif layout == "slot-major":
        v = base.view(N, Wt, C).permute(2, 0, 1)
    else:
        v = base.view(C, N, Wt)
    assert io_route(v, kernel_plan(C, 3 if C % 3 == 0 else 1, torch.bfloat16).WB) == want
