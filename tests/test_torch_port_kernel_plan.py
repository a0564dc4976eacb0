"""The Swin-block kernel's plan (`kernel_plan` in
swinwnet_tpu_torch/ops/swin_block.py): how a CTA is cut for a width, head
count and compute type. The CUDA launcher checks the same conditions and
refuses a plan that breaks one; here they are held without a card, for every
signature the three kernels meet on the serving and training paths and for
a few odd ones."""

import pytest
import torch

from swinwnet_tpu_torch.ops.swin_block import SMEM_MAX, WINDOW_TOKENS, kernel_plan

# (C, num_heads) of the on-path shapes: the channels-major kernel in serving,
# the row-major kernel in fp32 training with fused_deep, the wide kernel on
# the token-slot-major route
CST_LEVELS = [(48, 3), (96, 6), (96, 3), (24, 3), (12, 3)]
ROW_LEVELS = [(96, 6), (192, 12), (384, 24), (384, 12), (192, 6), (96, 3)]
WIDE_LEVELS = [(48, 3), (24, 3), (12, 3), (96, 3)]
ODD = [(4, 1), (12, 3), (384, 24), (768, 24)]
CASES = sorted(set(CST_LEVELS + ROW_LEVELS + WIDE_LEVELS + ODD))
DTYPES = [torch.float32, torch.bfloat16]


@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
@pytest.mark.parametrize("C,nH", CASES)
def test_plan_fits_the_card_and_the_kernel(C, nH, dtype):
    p = kernel_plan(C, nH, dtype)
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
