"""The Swin-block kernel's plan (`kernel_plan` in
swinwnet_tpu_torch/ops/swin_block.py): how a CTA is cut for a width, head
count and compute type. The CUDA launcher checks the same conditions and
refuses a plan that breaks one; here they are held without a card, for every
signature the three kernels meet on the serving and training paths and for
a few odd ones."""

import pytest
import torch

from swinwnet_tpu_torch.ops.swin_block import (
    SMEM_MAX,
    SMEM_CTAS,
    WINDOW_TOKENS,
    kernel_plan,
    mma_jobs,
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


def _check_mma_plan(p, C, nH):
    """The tensor-core body's invariants (bf16, qkv rounded, C <= 96)."""
    hd = C // nH
    M = WINDOW_TOKENS * p.WB
    assert p.body == (2 if C <= 48 else 1)  # weights resident exactly when C <= 48
    assert 1 <= p.WB <= 8 and p.mp % 16 == 0 and M <= p.mp < M + 16
    assert nH % p.G == 0 and p.HC % 16 == 0 and (4 * C) % p.HC == 0
    assert p.threads == 256
    # two CTAs an SM (at most 113 KB of shared memory each) or three (75 KB)
    assert p.min_ctas in (2, 3) and p.smem_bytes <= SMEM_CTAS[p.min_ctas] and 2 * (SMEM_CTAS[2] + 1024) <= 233472
    # bf16 operand rows hold C padded to 16, the chunk a head group's q|k|v
    # padded to 8 and a hidden chunk; each stride an odd number of 16-byte units
    assert p.lda >= -(-C // 16) * 16 and _units16(p.lda) % 2 == 1
    assert p.ldq >= max(-(-3 * p.G * hd // 8) * 8, p.HC) and _units16(p.ldq) % 2 == 1
    assert p.ldt == C + 4 and (4 * p.ldt) % 16 == 0
    # trunk, two operand buffers, chunk, weights: 16-byte aligned, in order, no overlap
    trunk, a1, a2, chunk, wts = p.offsets
    assert all(off % 16 == 0 for off in p.offsets)
    assert trunk == 0 and a1 >= 4 * M * p.ldt and a2 - a1 >= 2 * p.mp * p.lda
    assert chunk - a2 >= 2 * p.mp * p.lda and wts - chunk >= 2 * p.mp * p.ldq
    # each product's weights with K padded to 16 and O to 8, in either order
    jobs = mma_jobs(C, nH, p.G, p.HC)
    assert len(jobs) == nH // p.G + 1 + 2 * (4 * C // p.HC)
    nG = nH // p.G
    assert jobs[:nG + 1] == [(C, 3 * p.G * hd)] * nG + [(C, C)]
    assert jobs[nG + 1:] == [(C, p.HC), (p.HC, C)] * (4 * C // p.HC)  # fc1 and fc2 cover all 4C hidden columns
    sizes = []
    for K, O in jobs:
        Kp, Op = -(-K // 16) * 16, -(-O // 8) * 8
        oi = Op * (Kp + 8 * (_units16(Kp) % 2 == 0))
        io = Kp * (Op + 8 * (_units16(Op) % 2 == 0))
        sizes.append(max(oi, io))
    want = sum(sizes) if p.body == 2 else 2 * max(sizes)
    assert p.smem_bytes - wts == 2 * want
    if p.body == 1:  # slots are reused: no product may need a pad in K
        assert all(K % 16 == 0 for K, _ in jobs)


@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
@pytest.mark.parametrize("C,nH", CASES)
def test_plan_fits_the_card_and_the_kernel(C, nH, dtype):
    p = kernel_plan(C, nH, dtype)
    if dtype == torch.bfloat16 and C <= 96:
        _check_mma_plan(p, C, nH)
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
    """cst and wide (qkv rounded) in bf16 take the tensor-core body; with qkv
    kept fp32 (the row-major entry) the same width takes the fp32-FMA body's
    plan, as in fp32 apart from the weights' type."""
    p = kernel_plan(C, nH, torch.bfloat16, round_qkv)
    if round_qkv:
        _check_mma_plan(p, C, nH)
    else:
        assert p.body == 0 and p.CN in (4, 8)
        assert (p.WB, p.G, p.HC, p.OT, p.CN) == kernel_plan(C, nH, torch.float32)[:2] + kernel_plan(
            C, nH, torch.float32)[2:3] + kernel_plan(C, nH, torch.float32)[4:6]
    assert kernel_plan(C, nH, torch.float32, round_qkv) == kernel_plan(C, nH, torch.float32)


@pytest.mark.parametrize("C,nH", [(56, 14), (72, 6), (88, 2)])
def test_bf16_plan_above_48_off_16_takes_the_fma_body(C, nH):
    """Two weight slots are reused by every product, so no K may need a pad:
    C a multiple of 16. Other bf16 widths above 48 (no level of the model)
    take the fp32-FMA body."""
    p = kernel_plan(C, nH, torch.bfloat16)
    assert p.body == 0 and p.min_ctas == 1 and p.CN in (4, 8)
