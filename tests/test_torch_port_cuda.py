"""The CUDA kernel against its plain version, on the card (marked `cuda`;
skipped where no CUDA device is present). Runs with
`python -m pytest --noconftest tests/test_torch_port_cuda.py -q` on a
machine with an H100 (tests/conftest.py imports JAX); chip_smoke.py holds
the kernel to the same check at the pipeline's full shapes.

Tolerances as chip_smoke.py: 1e-4 * max|ref| in fp32, 2e-2 * max|ref| in
bf16 (a few ulps of the bf16 output)."""

import numpy as np
import pytest
import torch

from swinwnet_tpu_torch.ops import swin_block as sb
from swinwnet_tpu_torch.ops.window import window_pad_mask_np

N = 25


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C,nH,grid", [(48, 3, (25, 30)), (96, 6, (13, 24)), (96, 3, (25, 30)),
                                       (24, 3, (50, 60)), (12, 3, (100, 120))])
def test_kernel_matches_plain(cuda, C, nH, grid, dtype):
    g = torch.Generator().manual_seed(C + nH)
    A = lambda *s: torch.randn(*s, generator=g) * 0.05
    args = [torch.rand(C, generator=g) + 0.5, A(C), A(3 * C, C).to(dtype), A(3 * C), A(nH, N, N),
            A(C, C).to(dtype), A(C), torch.rand(C, generator=g) + 0.5, A(C),
            A(4 * C, C).to(dtype), A(4 * C), A(C, 4 * C).to(dtype), A(C)]
    args = [a.to(cuda) for a in args]
    m = window_pad_mask_np(*grid, 5)
    mask = None if m is None else torch.from_numpy(np.tile(m[:, :, 0], (2, 1))).to(cuda).t()
    Wt = 2 * (-(-grid[0] // 5)) * (-(-grid[1] // 5))
    x = torch.randn(Wt, N, C, generator=g).to(dtype).to(cuda).permute(2, 1, 0)
    before = sb.fused_swin_block_cst.launches
    out = sb.fused_swin_block_cst(x, *args, num_heads=nH, pad_mask=mask)
    torch.cuda.synchronize()
    assert sb.fused_swin_block_cst.launches == before + 1
    ref = sb.swin_block_plain(x, *args, num_heads=nH, pad_mask=mask)
    tol = (1e-4 if dtype == torch.float32 else 2e-2) * ref.float().abs().max().item()
    assert (out.float() - ref.float()).abs().max().item() <= tol
