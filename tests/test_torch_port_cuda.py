"""The CUDA kernels against their plain versions, and the differentiable
block's gradients, on the card (marked `cuda`;
skipped where no CUDA device is present). Runs with
`python -m pytest --noconftest tests/test_torch_port_cuda.py -q` on a
machine with an H100 (tests/conftest.py imports JAX); chip_smoke.py holds
the kernels to the same checks at the full model's shapes.

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


def _operands(cuda, C, nH, dtype, seed, linear_layout):
    """[in, out] operands of the row-major and wide entry points; with
    `linear_layout` the matrices are transposed views of [out, in] storage,
    as BasicLayer passes nn.Linear weights."""
    g = torch.Generator().manual_seed(seed)
    A = lambda *s: torch.randn(*s, generator=g) * 0.05
    mats = [A(C, 3 * C), A(C, C), A(C, 4 * C), A(4 * C, C)]
    mats = [m.to(dtype).to(cuda) for m in mats]
    if linear_layout:
        mats = [m.t().contiguous().t() for m in mats]
    v = [torch.rand(C, generator=g) + 0.5, A(C), A(3 * C), A(nH, N, N), A(C),
         torch.rand(C, generator=g) + 0.5, A(C), A(4 * C), A(C)]
    v = [t.to(cuda) for t in v]
    return [v[0], v[1], mats[0], v[2], v[3], mats[1], v[4], v[5], v[6], mats[2], v[7], mats[3], v[8]], g


@pytest.mark.cuda
@pytest.mark.parametrize("linear_layout", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C,nH,Wt,masked", [(96, 6, 131, True), (192, 12, 40, True), (384, 24, 13, True),
                                            (384, 12, 24, False), (192, 6, 37, False), (96, 3, 64, False)])
def test_rowmajor_kernel_matches_plain(cuda, C, nH, Wt, masked, dtype, linear_layout):
    args, g = _operands(cuda, C, nH, dtype, C + nH, linear_layout)
    x = torch.randn(Wt * N, C, generator=g).to(dtype).to(cuda)
    mask = (torch.rand(Wt * N, 1, generator=g) > 0.3).float().to(cuda) if masked else None
    before = sb.fused_swin_block.launches
    out = sb.fused_swin_block(x, *args, num_heads=nH, pad_mask=mask)
    torch.cuda.synchronize()
    assert sb.fused_swin_block.launches == before + 1
    ref = sb.swin_block_rowmajor_plain(x, *args, num_heads=nH, pad_mask=mask)
    tol = (1e-4 if dtype == torch.float32 else 2e-2) * ref.float().abs().max().item()
    assert (out.float() - ref.float()).abs().max().item() <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C,nH,Wt", [(48, 3, 300), (24, 3, 133), (12, 3, 1201), (96, 3, 61)])
def test_wide_kernel_matches_plain(cuda, C, nH, Wt, dtype):
    args, g = _operands(cuda, C, nH, dtype, C + nH, True)
    x = torch.randn(N, Wt, C, generator=g).to(dtype).to(cuda)
    before = sb.fused_swin_block_wide.launches
    out = sb.fused_swin_block_wide(x, *args, num_heads=nH)
    torch.cuda.synchronize()
    assert sb.fused_swin_block_wide.launches == before + 1
    ref = sb.swin_block_wide_plain(x, *args, num_heads=nH)
    tol = (1e-4 if dtype == torch.float32 else 2e-2) * ref.float().abs().max().item()
    assert (out.float() - ref.float()).abs().max().item() <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["cmajor", "rowmajor", "nmajor"])
def test_autodiff_gradients_match_the_fp32_reference(cuda, layout):
    """The Function's forward is the kernel (against the reference: 1e-4 *
    max|ref|) and its backward the plain fp32 reference (the same function
    autograd differentiates directly: 1e-6 * max|g| per tensor)."""
    C, nH, Wt = 48, 3, 150
    args, g = _operands(cuda, C, nH, torch.float32, 5, True)
    mask = None
    if layout == "cmajor":
        for i in (2, 9, 11):
            args[i] = args[i].t()
        x = torch.randn(Wt, N, C, generator=g).to(cuda).permute(2, 1, 0)
        mask = (torch.rand(Wt, N, generator=g) > 0.3).float().to(cuda).t()
    elif layout == "rowmajor":
        x = torch.randn(Wt * N, C, generator=g).to(cuda)
        mask = (torch.rand(Wt * N, 1, generator=g) > 0.3).float().to(cuda)
    else:
        x = torch.randn(N, Wt, C, generator=g).to(cuda)
    ct = torch.randn(x.shape, generator=g).to(cuda)
    a = [t.detach().clone().requires_grad_(True) for t in [x] + args]
    b = [t.detach().clone().requires_grad_(True) for t in [x] + args]
    launches = [k.launches for k in sb.KERNELS]
    out = sb.fused_block_autodiff(layout, nH, a[0], mask, *a[1:])
    assert sum(k.launches for k in sb.KERNELS) == sum(launches) + 1
    ref = sb._layout_reference(layout, nH, b[0], mask, *b[1:])
    assert (out - ref).abs().max().item() <= 1e-4 * ref.abs().max().item()
    got = torch.autograd.grad(out, a, ct)
    want = torch.autograd.grad(ref, b, ct)
    for p, q in zip(got, want):
        assert (p - q).abs().max().item() <= 1e-6 * q.abs().max().item()
