"""The CUDA kernels against their plain versions, the differentiable
block's gradients, and the fp32 layers against float64 under any TF32
flags, on the card (marked `cuda`;
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


@pytest.mark.cuda
@pytest.mark.parametrize("C,nH,Wt,masked,dtype", [(48, 3, 76800, False, torch.bfloat16),
                                                  (96, 6, 19968, True, torch.bfloat16),
                                                  (96, 3, 76800, False, torch.bfloat16),
                                                  (48, 3, 76800, False, torch.float32)])
def test_kernel_at_the_seg_only_b64_shapes(cuda, C, nH, Wt, masked, dtype):
    """The cst launches of SwinUNet at [64, 2, 250, 480] (the JAX bench's
    seg_only_b64_bf16): encoder L0, encoder L1 with the pad mask of its
    63x120 grid, the last decoder stage; in fp32 the gate sends only the
    first to the kernel."""
    g = torch.Generator().manual_seed(C + nH)
    A = lambda *s: torch.randn(*s, generator=g) * 0.05
    args = [torch.rand(C, generator=g) + 0.5, A(C), A(3 * C, C).to(dtype), A(3 * C), A(nH, N, N),
            A(C, C).to(dtype), A(C), torch.rand(C, generator=g) + 0.5, A(C),
            A(4 * C, C).to(dtype), A(4 * C), A(C, 4 * C).to(dtype), A(C)]
    args = [a.to(cuda) for a in args]
    mask = None
    if masked:
        mask = torch.from_numpy(np.tile(window_pad_mask_np(63, 120, 5)[:, :, 0], (64, 1))).to(cuda).t()
        assert mask.shape == (N, Wt)
    x = torch.randn(Wt, N, C, generator=g).to(dtype).to(cuda).permute(2, 1, 0)
    out = sb.fused_swin_block_cst(x, *args, num_heads=nH, pad_mask=mask)
    ref = sb.swin_block_plain(x, *args, num_heads=nH, pad_mask=mask)
    tol = (1e-4 if dtype == torch.float32 else 2e-2) * ref.float().abs().max().item()
    assert (out.float() - ref.float()).abs().max().item() <= tol


def _fp32_layers_against_float64(cuda):
    """The fp32 patch embedding (conv 2->48, stride 2, then LayerNorm) and
    segmentation head (conv 3x3 48->24, GELU, conv 1x1 24->1, bilinear x2)
    of the published width on the card, against the same weights in float64;
    returns the two max errors over max|float64|."""
    import torch.nn.functional as F

    from swinwnet_tpu_torch.models import ScaleAwarePatchEmbed, SegmentationHead, init_weights

    g = torch.Generator().manual_seed(0)
    embed, head = ScaleAwarePatchEmbed(2, 2, 48, torch.float32), SegmentationHead(48, 2, torch.float32)
    for m in (embed, head):
        init_weights(m, g)
        m.to(cuda)
    x = (torch.rand(2, 2, 250, 480, generator=g) * 1e3).to(cuda)
    t = torch.randn(2, 125, 240, 48, generator=g).to(cuda)
    with torch.no_grad():
        got_e, _ = embed(x)
        got_h = head(t, (250, 480))
        w, b = embed.proj.weight.double(), embed.proj.bias.double()
        ref_e = F.layer_norm(F.conv2d(x.double(), w, b, stride=2).permute(0, 2, 3, 1), (48,),
                             embed.norm.weight.double(), embed.norm.bias.double(), 1e-5)
        c1, c2 = head.seg_head[0], head.seg_head[2]
        y = F.gelu(F.conv2d(t.double().permute(0, 3, 1, 2), c1.weight.double(), c1.bias.double(), padding=1))
        y = F.conv2d(y, c2.weight.double(), c2.bias.double())
        ref_h = F.interpolate(y, scale_factor=2, mode="bilinear", align_corners=False)
    return [((a.double() - r).abs().max() / r.abs().max()).item() for a, r in ((got_e, ref_e), (got_h, ref_h))]


@pytest.mark.cuda
@pytest.mark.parametrize("flags", ["default", "tf32 on"])
def test_fp32_layers_stay_fp32_whatever_the_flags(cuda, flags):
    """Under PyTorch's default flags (cuDNN may use TF32) and with TF32 on
    for matmuls and convolutions, the port's fp32 layers agree with float64
    within 1e-5 of their max: they run their products under full_fp32."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    try:
        if flags == "tf32 on":
            torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
        errs = _fp32_layers_against_float64(cuda)
        assert (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32) == (
            (True, True) if flags == "tf32 on" else saved)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
    assert max(errs) <= 1e-5, errs


@pytest.mark.cuda
def test_fp32_check_fails_with_tf32_forced_on(cuda, monkeypatch):
    """The control: with full_fp32 made a no-op and TF32 on, the same check
    fails, so it can see TF32."""
    import contextlib

    from swinwnet_tpu_torch.models import layers

    monkeypatch.setattr(layers, "full_fp32", lambda dtype=torch.float32: contextlib.nullcontext())
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    assert max(_fp32_layers_against_float64(cuda)) > 1e-5


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
    """The bf16 Hopper body through the cst entry, with a pad mask, at
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
    """The bf16 Hopper body through the wide entry at window counts
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
@pytest.mark.parametrize("entry", ["cst", "wide"])
@pytest.mark.parametrize("C,nH", TC_SHAPES)
def test_tensor_core_ragged_batch_in_the_second_stage(cuda, C, nH, entry):
    """The persistent bodies' pipelines: a window count whose last batch is
    ragged and the second its persistent CTA (the Hopper body) or warp (the
    narrow body, 8 a CTA) takes, loaded into the second stage while the
    first computes, and one a batch longer."""
    plan = sb.kernel_plan(C, nH, torch.bfloat16)
    assert plan.body in (1, 2)
    ctas = plan.min_ctas * torch.cuda.get_device_properties(0).multi_processor_count
    walkers = ctas * (plan.threads // 32 if plan.body == 2 else 1)
    for Wt in (plan.WB * (walkers + 5) + max(1, plan.WB // 2), plan.WB * (walkers + 6) + max(1, plan.WB // 2)):
        if entry == "cst":
            args, g = _cst_operands(cuda, C, nH, C + nH + Wt, "in_out")
            x = torch.randn(Wt, N, C, generator=g).to(torch.bfloat16).to(cuda).permute(2, 1, 0)
            mask = (torch.rand(N, Wt, generator=g) > 0.3).float().to(cuda)
            out = sb.fused_swin_block_cst(x, *args, num_heads=nH, pad_mask=mask)
            ref = sb.swin_block_plain(x, *args, num_heads=nH, pad_mask=mask)
        else:
            args, g = _operands(cuda, C, nH, torch.bfloat16, C + nH + Wt, True)
            x = torch.randn(N, Wt, C, generator=g).to(torch.bfloat16).to(cuda)
            out = sb.fused_swin_block_wide(x, *args, num_heads=nH)
            ref = sb.swin_block_wide_plain(x, *args, num_heads=nH)
        torch.cuda.synchronize()
        tol = 2e-2 * ref.float().abs().max().item()
        assert (out.float() - ref.float()).abs().max().item() <= tol, f"Wt={Wt}"


@pytest.mark.cuda
@pytest.mark.parametrize("stored", ["out_in", "in_out"])
@pytest.mark.parametrize("C,nH", [(4, 1), (16, 4), (32, 1), (40, 5), (64, 4), (80, 5), (96, 1), (96, 12)])
def test_tensor_core_cst_at_other_widths(cuda, C, nH, stored):
    """The tensor-core bodies at widths no serving level has: the narrow
    body's instance of the width and head width (C <= 24); the Hopper
    body's instance that reads its widths at run time, or one that fixes
    them where they agree (C = 96 with 1 or 12 heads), qkv in one product or
    three parts, resident and streamed weights; stored either way."""
    plan = sb.kernel_plan(C, nH, torch.bfloat16)
    if C <= sb.NARROW_MAX_C:
        assert plan.body == 2
    else:
        assert plan.body == 1 and plan.variant == (4 if C == 96 else 0)
    args, g = _cst_operands(cuda, C, nH, C + nH, stored)
    for Wt in (plan.WB + 1, 1201):
        x = torch.randn(Wt, N, C, generator=g).to(torch.bfloat16).to(cuda).permute(2, 1, 0)
        mask = (torch.rand(N, Wt, generator=g) > 0.3).float().to(cuda)
        out = sb.fused_swin_block_cst(x, *args, num_heads=nH, pad_mask=mask)
        torch.cuda.synchronize()
        ref = sb.swin_block_plain(x, *args, num_heads=nH, pad_mask=mask)
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
# The narrow body (bf16 cst and wide at C <= 24) against swin_block_plain
# ---------------------------------------------------------------------------

# (C, nH): the SR head's two levels, then other head widths (4 to 24) that
# other instances of the body take, packed (16, 4) or a head at a time
NARROW_LEVELS = [(12, 3), (24, 3), (16, 4), (24, 1), (24, 2), (24, 6), (12, 1), (20, 5), (16, 2), (8, 1), (4, 1)]


def _narrow_view(layout, Wt, C, g, cuda):
    """bf16 windows as the [C, N, Wt] view of one storage layout: the
    token-major windows the models pass (one run of bytes), the same with
    rows padded to C + 8 channels, the token-slot-major [N, Wt, C] array, the
    channels-major [C, N, Wt] array, and token-major windows one element
    past an aligned start (no vector route). Returns the view and its
    storage, whose other elements the kernel must leave alone."""
    x = torch.randn(Wt, N, C, generator=g).to(torch.bfloat16)
    if layout == "token-major":
        return x.to(cuda).permute(2, 1, 0), None
    if layout == "padded-rows":
        base = torch.randn(Wt, N, C + 8, generator=g).to(torch.bfloat16).to(cuda)
        base[..., :C] = x.to(cuda)
        return base[..., :C].permute(2, 1, 0), base
    if layout == "slot-major":
        return x.transpose(0, 1).contiguous().to(cuda).permute(2, 0, 1), None
    if layout == "channels-major":
        return x.permute(2, 1, 0).contiguous().to(cuda), None
    base = torch.randn(Wt * N * C + 1, generator=g).to(torch.bfloat16).to(cuda)
    base[1:] = x.to(cuda).reshape(-1)
    return base[1:].view(Wt, N, C).permute(2, 1, 0), base


@pytest.mark.cuda
@pytest.mark.parametrize("stored", ["out_in", "in_out"])
@pytest.mark.parametrize("C,nH", NARROW_LEVELS)
def test_narrow_cst_matches_plain(cuda, C, nH, stored):
    """The narrow body through the cst entry, weights stored either way, at
    tiny window counts (fewer windows than a CTA's warps), around a warp's
    unit of windows, and a prime; with and without a pad mask; one launch,
    counted on the entry and on swin_block_narrow."""
    plan = sb.kernel_plan(C, nH, torch.bfloat16)
    assert plan.body == 2
    args, g = _cst_operands(cuda, C, nH, 7 * C + nH, stored)
    for Wt in sorted({1, 2, 3, plan.WB + 1, 17, 1201}):
        for masked in (False, True):
            x = torch.randn(Wt, N, C, generator=g).to(torch.bfloat16).to(cuda).permute(2, 1, 0)
            mask = (torch.rand(N, Wt, generator=g) > 0.3).float().to(cuda) if masked else None
            keep = x.clone()
            before = sb.fused_swin_block_cst.launches, sb.NARROW_LAUNCHES.launches
            out = sb.fused_swin_block_cst(x, *args, num_heads=nH, pad_mask=mask)
            torch.cuda.synchronize()
            assert (sb.fused_swin_block_cst.launches, sb.NARROW_LAUNCHES.launches) == (before[0] + 1, before[1] + 1)
            assert torch.equal(x, keep)
            ref = sb.swin_block_plain(x, *args, num_heads=nH, pad_mask=mask)
            tol = 2e-2 * ref.float().abs().max().item()
            assert (out.float() - ref.float()).abs().max().item() <= tol, f"Wt={Wt} masked={masked}"


@pytest.mark.cuda
@pytest.mark.parametrize("linear_layout", [False, True])
@pytest.mark.parametrize("C,nH", NARROW_LEVELS)
def test_narrow_wide_matches_plain(cuda, C, nH, linear_layout):
    """The narrow body through the wide entry ([N, Wt, C] windows), weights
    stored either way, at tiny, unit-sized and prime window counts."""
    args, g = _operands(cuda, C, nH, torch.bfloat16, 5 * C + nH, linear_layout)
    for Wt in sorted({1, 2, 3, 17, 1201}):
        x = torch.randn(N, Wt, C, generator=g).to(torch.bfloat16).to(cuda)
        before = sb.NARROW_LAUNCHES.launches
        out = sb.fused_swin_block_wide(x, *args, num_heads=nH)
        torch.cuda.synchronize()
        assert sb.NARROW_LAUNCHES.launches == before + 1
        ref = sb.swin_block_wide_plain(x, *args, num_heads=nH)
        tol = 2e-2 * ref.float().abs().max().item()
        assert (out.float() - ref.float()).abs().max().item() <= tol, f"Wt={Wt}"


@pytest.mark.cuda
@pytest.mark.parametrize("grid", [(52, 96), (26, 48), (13, 7)])
@pytest.mark.parametrize("C,nH", [(12, 3), (24, 3)])
def test_narrow_at_padded_grids(cuda, C, nH, grid):
    """The SR head's levels on grids that do not tile by 5 (the RL step's
    padded half-size upscale gives such grids), with the pad mask of the
    grid, at B = 2."""
    args, g = _cst_operands(cuda, C, nH, C + grid[0], "out_in")
    m = window_pad_mask_np(*grid, 5)
    mask = torch.from_numpy(np.tile(m[:, :, 0], (2, 1))).to(cuda).t()
    Wt = 2 * (-(-grid[0] // 5)) * (-(-grid[1] // 5))
    x = torch.randn(Wt, N, C, generator=g).to(torch.bfloat16).to(cuda).permute(2, 1, 0)
    out = sb.fused_swin_block_cst(x, *args, num_heads=nH, pad_mask=mask)
    torch.cuda.synchronize()
    ref = sb.swin_block_plain(x, *args, num_heads=nH, pad_mask=mask)
    assert (out.float() - ref.float()).abs().max().item() <= 2e-2 * ref.float().abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["token-major", "padded-rows", "slot-major", "channels-major", "unaligned"])
@pytest.mark.parametrize("C,nH", [(12, 3), (24, 3)])
def test_narrow_every_window_route(cuda, C, nH, layout):
    """Each way the narrow body moves windows (one run of 16-byte units,
    8- or 4-channel units, element by element), in and out: the output
    written over the input through the launcher (the entries always
    allocate), and, read back, the same as the plain version's on a copy;
    what lies around the windows is left alone."""
    args, g = _cst_operands(cuda, C, nH, C + nH + len(layout), "in_out")
    for Wt in (3, 1201):
        x, storage = _narrow_view(layout, Wt, C, g, cuda)
        mask = (torch.rand(N, Wt, generator=g) > 0.3).float().to(cuda)
        ref = sb.swin_block_plain(x.clone(), *args, num_heads=nH, pad_mask=mask)
        around = None if storage is None else storage.clone()
        weights_oi = (args[2], args[5].t(), args[9], args[11])
        fp32 = (args[0], args[1], args[3], args[6], args[7], args[8], args[10], args[12], args[4])
        sb._launch(sb.fused_swin_block_cst, x, x, mask, weights_oi, fp32, nH, True, True)
        torch.cuda.synchronize()
        assert (x.float() - ref.float()).abs().max().item() <= 2e-2 * ref.float().abs().max().item(), f"Wt={Wt}"
        if storage is not None:
            outside = torch.ones_like(storage, dtype=torch.bool)
            if layout == "padded-rows":
                outside[..., :C] = False
            else:
                outside[1:] = False
            assert torch.equal(storage[outside], around[outside])


@pytest.mark.cuda
def test_narrow_erf_is_erff_for_every_float(cuda):
    """The narrow body's GELU evaluates erf with both of the library's
    polynomials and one select (nb_erf): every one of the 2^32 floats gives
    erff's bits."""
    bad = torch.zeros(1, dtype=torch.int64, device=cuda)
    lib = sb._load()
    assert lib.swin_block_erf_check(bad.data_ptr(), torch.cuda.current_stream().cuda_stream) == 0
    torch.cuda.synchronize()
    assert bad.item() == 0


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


@pytest.mark.cuda
@pytest.mark.parametrize("grid", [(125, 240), (63, 120)])
def test_shifted_level_on_the_card_matches_the_cpu(cuda, grid):
    """BasicLayer(48, 3 heads, shift 2) at encoder L0's grid and at one that
    does not tile, fp32: 1e-5 of max (cuBLAS and the CPU summing apart)."""
    from swinwnet_tpu_torch.models import BasicLayer, init_weights

    layer = BasicLayer(48, 2, 3, shift_size=2).eval()
    init_weights(layer, torch.Generator().manual_seed(0))
    x = torch.randn(2, *grid, 48, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        want = layer(x)
        got = layer.to(cuda)(x.to(cuda))
    assert (got.cpu() - want).abs().max().item() <= 1e-5 * want.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dropout_draws_on_the_card(cuda, dtype):
    from swinwnet_tpu_torch.models.layers import dropout

    x = torch.ones(8, 2, 250, 480, device=cuda, dtype=dtype)
    draw = lambda seed: dropout(x, 0.1, False, torch.Generator(device=cuda).manual_seed(seed))
    a, b, c = draw(0), draw(0), draw(1)
    assert torch.equal(a, b) and not torch.equal(a, c)
    kept = a != 0
    assert abs(kept.float().mean().item() - 0.9) < 0.005
    assert torch.equal(a[kept], torch.full_like(a[kept], 1.0) / 0.9)


@pytest.mark.cuda
def test_one_rank_nccl_dryrun(cuda):
    from swinwnet_tpu_torch.parallel import dryrun_multichip

    out = dryrun_multichip(1, hw=(40, 60), model_kw=dict(embed_dim=12, depths=(1, 1, 1, 1), num_heads=(3, 3, 3, 3)))
    assert np.isfinite(out["loss"]) and len(out["grads"]) > 100
