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
                                       (24, 3, (50, 60)), (12, 3, (100, 120)),
                                       # padded grids at every shape, as the RL step's half-size upscale gives them
                                       (48, 3, (13, 24)), (96, 6, (7, 12)), (96, 3, (13, 24)),
                                       (24, 3, (26, 48)), (12, 3, (52, 96))])
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


def _window_counts(C, nH, dtype, round_qkv=False):
    """Window counts below, at and around the plan's windows per CTA, and a
    prime that no count divides (the row-major entry's plan, or with
    `round_qkv` that of cst and wide)."""
    WB = sb.kernel_plan(C, nH, dtype, round_qkv).WB
    return sorted({1, max(1, WB - 1), WB, WB + 1, 1201})


@pytest.mark.cuda
@pytest.mark.parametrize("linear_layout", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C,nH", [(96, 3), (192, 12)])
def test_rowmajor_kernel_at_ragged_window_counts(cuda, C, nH, dtype, linear_layout):
    """The last CTA masks its own ragged edge: counts around the plan's
    windows per CTA, weights stored either way. The wrapper always returns a
    new tensor, so `out` aliasing `x`, which the kernel allows (it reads a
    CTA's windows before it writes them), cannot be asked for here."""
    args, g = _operands(cuda, C, nH, dtype, C + nH, linear_layout)
    for Wt in _window_counts(C, nH, dtype):
        x = torch.randn(Wt * N, C, generator=g).to(dtype).to(cuda)
        mask = (torch.rand(Wt * N, 1, generator=g) > 0.3).float().to(cuda)
        keep = x.clone()
        out = sb.fused_swin_block(x, *args, num_heads=nH, pad_mask=mask)
        torch.cuda.synchronize()
        assert torch.equal(x, keep)
        ref = sb.swin_block_rowmajor_plain(x, *args, num_heads=nH, pad_mask=mask)
        tol = (1e-4 if dtype == torch.float32 else 2e-2) * ref.float().abs().max().item()
        assert (out.float() - ref.float()).abs().max().item() <= tol, f"Wt={Wt}"


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


def _cst_operands(cuda, C, nH, seed, stored):
    """bf16 operands of the cst entry with all four weights stored [out, in]
    or all [in, out] (`stored`), as views in the entry's orientation."""
    g = torch.Generator().manual_seed(seed)
    A = lambda *s: torch.randn(*s, generator=g) * 0.05
    oi = [A(3 * C, C), A(C, C), A(4 * C, C), A(C, 4 * C)]  # [out, in]
    oi = [m.to(torch.bfloat16).to(cuda) for m in oi]
    if stored == "in_out":
        oi = [m.t().contiguous().t() for m in oi]
    v = [torch.rand(C, generator=g) + 0.5, A(C), A(3 * C), A(nH, N, N), A(C),
         torch.rand(C, generator=g) + 0.5, A(C), A(4 * C), A(C)]
    v = [t.to(cuda) for t in v]
    # the cst entry takes wqkv_t, w1_t, w2_t as [out, in] and wproj_t as [in, out]
    return [v[0], v[1], oi[0], v[2], v[3], oi[1].t(), v[4], v[5], v[6], oi[2], v[7], oi[3], v[8]], g


# (C, nH): head widths 4, 8, 16 and 32 on the bf16 serving levels
TC_SHAPES = [(12, 3), (24, 3), (48, 3), (96, 6), (96, 3)]


@pytest.mark.cuda
@pytest.mark.parametrize("stored", ["out_in", "in_out"])
@pytest.mark.parametrize("C,nH", TC_SHAPES)
def test_tensor_core_cst_at_ragged_window_counts(cuda, C, nH, stored):
    """The bf16 tensor-core body through the cst entry, with a pad mask, at
    window counts below, at and around its windows per CTA and at a prime,
    weights stored either way."""
    args, g = _cst_operands(cuda, C, nH, C + nH, stored)
    assert sb.kernel_plan(C, nH, torch.bfloat16).body != 0
    for Wt in _window_counts(C, nH, torch.bfloat16, round_qkv=True):
        x = torch.randn(Wt, N, C, generator=g).to(torch.bfloat16).to(cuda).permute(2, 1, 0)
        mask = (torch.rand(N, Wt, generator=g) > 0.3).float().to(cuda)
        keep = x.clone()
        out = sb.fused_swin_block_cst(x, *args, num_heads=nH, pad_mask=mask)
        torch.cuda.synchronize()
        assert torch.equal(x, keep)
        ref = sb.swin_block_plain(x, *args, num_heads=nH, pad_mask=mask)
        tol = 2e-2 * ref.float().abs().max().item()
        assert (out.float() - ref.float()).abs().max().item() <= tol, f"Wt={Wt}"


@pytest.mark.cuda
@pytest.mark.parametrize("linear_layout", [False, True])
@pytest.mark.parametrize("C,nH", TC_SHAPES)
def test_tensor_core_wide_at_ragged_window_counts(cuda, C, nH, linear_layout):
    """The bf16 tensor-core body through the wide entry at window counts
    around its windows per CTA and at a prime, weights stored either way."""
    args, g = _operands(cuda, C, nH, torch.bfloat16, C + nH, linear_layout)
    for Wt in _window_counts(C, nH, torch.bfloat16, round_qkv=True):
        x = torch.randn(N, Wt, C, generator=g).to(torch.bfloat16).to(cuda)
        out = sb.fused_swin_block_wide(x, *args, num_heads=nH)
        torch.cuda.synchronize()
        ref = sb.swin_block_wide_plain(x, *args, num_heads=nH)
        tol = 2e-2 * ref.float().abs().max().item()
        assert (out.float() - ref.float()).abs().max().item() <= tol, f"Wt={Wt}"


@pytest.mark.cuda
@pytest.mark.parametrize("C,nH", TC_SHAPES)
def test_tensor_core_output_may_alias_the_input(cuda, C, nH):
    """The launcher with the output on the input's memory (the wrappers
    always allocate): a CTA reads its windows before it writes them."""
    args, g = _cst_operands(cuda, C, nH, C + nH, "out_in")
    Wt = 1201
    x = torch.randn(Wt, N, C, generator=g).to(torch.bfloat16).to(cuda).permute(2, 1, 0)
    mask = (torch.rand(N, Wt, generator=g) > 0.3).float().to(cuda)
    ref = sb.swin_block_plain(x, *args, num_heads=nH, pad_mask=mask)
    weights_oi = (args[2], args[5].t(), args[9], args[11])
    fp32 = (args[0], args[1], args[3], args[6], args[7], args[8], args[10], args[12], args[4])
    sb._launch(sb.fused_swin_block_cst, x, x, mask, weights_oi, fp32, nH, True, True)
    torch.cuda.synchronize()
    assert (x.float() - ref.float()).abs().max().item() <= 2e-2 * ref.float().abs().max().item()


# ---------------------------------------------------------------------------
# The d-space physics on the card against the same functions on the CPU
# ---------------------------------------------------------------------------


def _synth_spectra(seed, B, n, n_peaks=8):
    rng = np.random.default_rng(seed)
    x = np.linspace(0, 7.5, n)
    out = np.zeros((B, n))
    for b in range(B):
        for _ in range(n_peaks):
            out[b] += rng.uniform(0.3, 5.0) * np.exp(-0.5 * ((x - rng.uniform(0.3, 7.0)) / rng.uniform(0.03, 0.12)) ** 2)
    return out.astype(np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(250, 480), (500, 960)])
def test_rebin_on_the_card_matches_the_cpu(cuda, shape):
    """Each bin is summed in pixel order on both devices (segment_reduce):
    fp32 rounding of the same sums, 1e-6 relative."""
    from swinwnet_tpu_torch.physics import Qwrapper, d_centers_hr

    x = torch.from_numpy(np.random.default_rng(1).uniform(0, 1e3, (4, 1, *shape)).astype(np.float32))
    qw = Qwrapper(fixed_centers=d_centers_hr)
    got = qw.rebin(x.to(cuda))
    assert got.device.type == "cuda"
    want = qw.rebin(x)
    assert torch.allclose(got.cpu(), want, rtol=1e-6, atol=0)
    assert torch.equal(qw.rebin(x.to(cuda)), got)  # deterministic on the card


@pytest.mark.cuda
@pytest.mark.parametrize("seed", range(3))
def test_device_metrics_on_the_card_match_the_cpu(cuda, seed):
    from swinwnet_tpu_torch.physics import d_centers_hr
    from swinwnet_tpu_torch.physics.device_metrics import diffraction_metrics_device

    pred = _synth_spectra(seed, 4, len(d_centers_hr))
    true = pred * np.float32(1.1) + _synth_spectra(seed + 10, 4, len(d_centers_hr), 2) * np.float32(0.3)
    got = diffraction_metrics_device(torch.from_numpy(pred).to(cuda), torch.from_numpy(true).to(cuda), d_centers_hr)
    want = diffraction_metrics_device(torch.from_numpy(pred), torch.from_numpy(true), d_centers_hr)
    for key, value in want.items():
        assert got[key].device.type == "cuda"
        assert torch.allclose(got[key].cpu(), value, rtol=1e-4, atol=1e-5), key
    assert (want["Integral Intensity"] > 0).all()
