"""The port's row-major and wide fused-block entry points
(swinwnet_tpu_torch/ops/swin_block.py: `fused_swin_block`,
`fused_swin_block_wide`, their plain versions) against the JAX package's
Pallas kernels in interpret mode, on the same numpy inputs.

On the CPU the wrappers run the kernels' plain versions; the CUDA kernels
are held against those plain versions on the card by chip_smoke.py and
tests/test_torch_port_cuda.py.

Tolerances: fp32 against fp32 is 1e-5 * max|ref| (both sides fp32, sums in
other orders; observed about 1e-7 relative). bf16 against the fp32 truth is
the bound of tests/test_swin_block_kernel.py:90-118 (same cast points, so
the same quantization error); bf16 against the JAX kernel in bf16 is
1e-2 * max|ref|, a few bf16 ulps of the output (2^-8 = 3.9e-3).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swinwnet_tpu.ops.pallas.swin_block import fused_swin_block as jax_rowmajor
from swinwnet_tpu.ops.pallas.swin_block import fused_swin_block_wide as jax_wide
from swinwnet_tpu.ops.pallas.swin_block import swin_block_reference as jax_reference
from swinwnet_tpu_torch.ops import swin_block as sb

torch.set_num_threads(1)

N = 25
# every (C, nH) signature of the full model (tests/test_swin_block_kernel.py:54-59)
SIGNATURES = [(48, 3), (96, 6), (192, 12), (384, 24), (384, 12), (192, 6), (96, 3), (24, 3), (12, 3)]
KEYS = ("ln1_s", "ln1_b", "wqkv", "bqkv", "rel_bias", "wproj", "bproj",
        "ln2_s", "ln2_b", "w1", "b1", "w2", "b2")
MATRICES = ("wqkv", "wproj", "w1", "w2")


def make_args(rng, C, nH):
    """Row-major ([in, out]) fp32 numpy weights, as the JAX tests make them."""
    A = lambda *s: (rng.standard_normal(s) * 0.05).astype(np.float32)
    return dict(
        ln1_s=rng.uniform(0.5, 1.5, C).astype(np.float32), ln1_b=A(C),
        wqkv=A(C, 3 * C), bqkv=A(3 * C), rel_bias=A(nH, N, N),
        wproj=A(C, C), bproj=A(C),
        ln2_s=rng.uniform(0.5, 1.5, C).astype(np.float32), ln2_b=A(C),
        w1=A(C, 4 * C), b1=A(4 * C), w2=A(4 * C, C), b2=A(C),
    )


def port_args(args, dtype, linear_layout=False):
    """The port's operands. With `linear_layout` the matrices are the
    transposed views of [out, in] storage, as BasicLayer passes them."""
    out = []
    for k in KEYS:
        t = torch.from_numpy(args[k])
        if k in MATRICES:
            t = t.to(dtype)
            if linear_layout:
                t = t.t().contiguous().t()
        out.append(t)
    return out


def jax_args(args, dtype):
    return [jnp.asarray(args[k]).astype(dtype) if k in MATRICES else jnp.asarray(args[k]) for k in KEYS]


def to_wide(x2, Wt):
    return np.ascontiguousarray(x2.reshape(Wt, N, -1).transpose(1, 0, 2))


@pytest.mark.parametrize("C,nH", SIGNATURES)
def test_rowmajor_fp32_matches_jax_kernel(C, nH):
    rng = np.random.default_rng(C * 31 + nH)
    Wt = 6
    x = rng.standard_normal((Wt * N, C)).astype(np.float32)
    args = make_args(rng, C, nH)
    sb.reset_counts()
    got = sb.fused_swin_block(torch.from_numpy(x), *port_args(args, torch.float32, True), num_heads=nH).numpy()
    assert (sb.fused_swin_block.launches, sb.fused_swin_block.plain_calls) == (0, 1)
    want = np.asarray(jax_rowmajor(jnp.asarray(x), *jax_args(args, jnp.float32), num_heads=nH,
                                   window_tokens=N, block_windows=2, interpret=True))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("C,nH", SIGNATURES)
def test_wide_fp32_matches_jax_kernel(C, nH):
    rng = np.random.default_rng(C * 17 + nH)
    Wt = 8
    x = to_wide(rng.standard_normal((Wt * N, C)).astype(np.float32), Wt)
    args = make_args(rng, C, nH)
    sb.reset_counts()
    got = sb.fused_swin_block_wide(torch.from_numpy(x), *port_args(args, torch.float32), num_heads=nH).numpy()
    assert (sb.fused_swin_block_wide.launches, sb.fused_swin_block_wide.plain_calls) == (0, 1)
    want = np.asarray(jax_wide(jnp.asarray(x), *jax_args(args, jnp.float32), num_heads=nH,
                               block_windows=8, score_chunk=min(8, C // nH), interpret=True))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


def test_rowmajor_pad_mask_matches_jax_kernel():
    """The [Wt*N, 1] pad mask zeroes slots after LN1 (tests/test_swin_block_kernel.py:238)."""
    rng = np.random.default_rng(7)
    C, nH, Wt = 192, 12, 6
    x = rng.standard_normal((Wt * N, C)).astype(np.float32)
    args = make_args(rng, C, nH)
    mask = (rng.uniform(size=(Wt * N, 1)) > 0.3).astype(np.float32)
    mask[:N] = 1.0  # one fully real window
    got = sb.fused_swin_block(torch.from_numpy(x), *port_args(args, torch.float32), num_heads=nH,
                              pad_mask=torch.from_numpy(mask)).numpy()
    want = np.asarray(jax_rowmajor(jnp.asarray(x), *jax_args(args, jnp.float32), num_heads=nH,
                                   window_tokens=N, pad_mask=jnp.asarray(mask), block_windows=2,
                                   interpret=True))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())
    unmasked = sb.swin_block_rowmajor_plain(torch.from_numpy(x), *port_args(args, torch.float32), num_heads=nH)
    assert np.abs(unmasked.numpy() - want).max() > 1e-3  # the mask matters


@pytest.mark.parametrize("layout,Wt,bw", [("rowmajor", 13, 8), ("wide", 37, 16)])
def test_window_count_no_block_divides(layout, Wt, bw):
    """The JAX entry points pad the window count to their block; the port
    takes any count (tests/test_swin_block_kernel.py:77,140)."""
    rng = np.random.default_rng(3)
    C, nH = 48, 3
    x2 = rng.standard_normal((Wt * N, C)).astype(np.float32)
    args = make_args(rng, C, nH)
    if layout == "rowmajor":
        got = sb.fused_swin_block(torch.from_numpy(x2), *port_args(args, torch.float32), num_heads=nH).numpy()
        want = np.asarray(jax_rowmajor(jnp.asarray(x2), *jax_args(args, jnp.float32), num_heads=nH,
                                       window_tokens=N, block_windows=bw, interpret=True))
    else:
        x3 = to_wide(x2, Wt)
        got = sb.fused_swin_block_wide(torch.from_numpy(x3), *port_args(args, torch.float32), num_heads=nH).numpy()
        want = np.asarray(jax_wide(jnp.asarray(x3), *jax_args(args, jnp.float32), num_heads=nH,
                                   block_windows=bw, interpret=True))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("layout,C,nH", [("rowmajor", 48, 3), ("rowmajor", 384, 12), ("wide", 48, 3), ("wide", 12, 3)])
def test_bf16_error_bounded(layout, C, nH):
    """bf16 deviation from the fp32 truth within the JAX kernel test's bound,
    and the bf16 plain version agrees with the JAX kernel in bf16."""
    rng = np.random.default_rng(C)
    Wt = 8
    x2 = rng.standard_normal((Wt * N, C)).astype(np.float32)
    args = make_args(rng, C, nH)
    ref32 = np.asarray(jax_reference(jnp.asarray(x2), *jax_args(args, jnp.float32), num_heads=nH, window_tokens=N))
    if layout == "rowmajor":
        got = sb.fused_swin_block(torch.from_numpy(x2).bfloat16(), *port_args(args, torch.bfloat16),
                                  num_heads=nH).float().numpy()
        jx = np.asarray(jax_rowmajor(jnp.asarray(x2).astype(jnp.bfloat16), *jax_args(args, jnp.bfloat16),
                                     num_heads=nH, window_tokens=N, block_windows=8, interpret=True), np.float32)
    else:
        got = sb.fused_swin_block_wide(torch.from_numpy(to_wide(x2, Wt)).bfloat16(),
                                       *port_args(args, torch.bfloat16), num_heads=nH).float().numpy()
        jx = np.asarray(jax_wide(jnp.asarray(to_wide(x2, Wt)).astype(jnp.bfloat16), *jax_args(args, jnp.bfloat16),
                                 num_heads=nH, block_windows=8, score_chunk=min(8, C // nH), interpret=True),
                        np.float32)
        ref32 = to_wide(ref32, Wt)
    scale = np.abs(ref32).max()
    assert np.abs(got - ref32).max() < 0.05 * scale + 0.05
    np.testing.assert_allclose(got, jx, rtol=0, atol=1e-2 * np.abs(jx).max())


def test_rowmajor_keeps_qkv_fp32_where_the_others_round():
    """The one cast point that differs between the kernels: in bf16 the
    row-major plain version differs from the wide one on the same windows."""
    rng = np.random.default_rng(11)
    C, nH, Wt = 48, 3, 8
    x2 = rng.standard_normal((Wt * N, C)).astype(np.float32)
    targs = port_args(make_args(rng, C, nH), torch.bfloat16)
    row = sb.swin_block_rowmajor_plain(torch.from_numpy(x2).bfloat16(), *targs, num_heads=nH).float().numpy()
    wide = sb.swin_block_wide_plain(torch.from_numpy(to_wide(x2, Wt)).bfloat16(), *targs, num_heads=nH).float().numpy()
    assert np.abs(to_wide(row, Wt) - wide).max() > 0


def test_reference_matches_jax_reference():
    rng = np.random.default_rng(5)
    C, nH, Wt = 96, 6, 5
    x = rng.standard_normal((Wt * N, C)).astype(np.float32)
    args = make_args(rng, C, nH)
    mask = (rng.uniform(size=(Wt * N, 1)) > 0.3).astype(np.float32)
    got = sb.swin_block_reference(torch.from_numpy(x), *port_args(args, torch.float32), num_heads=nH,
                                  pad_mask=torch.from_numpy(mask)).numpy()
    want = np.asarray(jax_reference(jnp.asarray(x), *jax_args(args, jnp.float32), num_heads=nH,
                                    window_tokens=N, pad_mask=jnp.asarray(mask)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


def test_wrappers_reject_bad_operands():
    rng = np.random.default_rng(4)
    C, nH, Wt = 12, 3, 4
    targs = port_args(make_args(rng, C, nH), torch.float32)
    x2 = torch.from_numpy(rng.standard_normal((Wt * N, C)).astype(np.float32))
    with pytest.raises(ValueError, match="wqkv"):
        bad = list(targs)
        bad[2] = bad[2].t().contiguous()  # [out, in] where [in, out] is wanted
        sb.fused_swin_block(x2, *bad, num_heads=nH)
    with pytest.raises(ValueError, match="pad_mask"):
        sb.fused_swin_block(x2, *targs, num_heads=nH, pad_mask=torch.ones(N, Wt))
    with pytest.raises(ValueError, match="Wt"):
        sb.fused_swin_block(x2[:-1], *targs, num_heads=nH)
    with pytest.raises(ValueError, match="N, Wt, C"):
        sb.fused_swin_block_wide(x2, *targs, num_heads=nH)
    with pytest.raises(ValueError, match="no pad mask"):
        sb.fused_block_autodiff("nmajor", nH, x2.reshape(Wt, N, C).transpose(0, 1), torch.ones(N, Wt), *targs)
