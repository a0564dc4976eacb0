"""The port's fused Swin-block module (swinwnet_tpu_torch/ops/swin_block.py)
against the JAX package's `fused_swin_block_cst` (Pallas, interpret mode)
and `swin_block_reference`.

On the CPU the wrapper runs the kernel's plain PyTorch version; the CUDA
kernel itself is held against that plain version on the card by
chip_smoke.py and tests/test_torch_port_cuda.py.

Tolerances: fp32 against fp32 is 1e-5 * max|ref| (both sides are fp32 with
sums in other orders; observed about 1e-7 relative). bf16 against the fp32
truth is the bound of tests/test_swin_block_kernel.py:90-118 (same cast
points, so the same quantization error); bf16 against the JAX kernel in
bf16 is 1e-2 * max|ref|, a few bf16 ulps of the output (2^-8 = 3.9e-3).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from swinwnet_tpu.ops.pallas.swin_block import fused_swin_block_cst as jax_cst
from swinwnet_tpu.ops.pallas.swin_block import swin_block_reference
from swinwnet_tpu_torch.ops import swin_block as sb

torch.set_num_threads(1)

N = 25
# the five (C, nH) signatures the serving pipeline sends to the kernel:
# encoder L0, encoder L1 (padded grid), last decoder stage, SR levels 1 and 2
SIGNATURES = [(48, 3), (96, 6), (96, 3), (24, 3), (12, 3)]
KEYS = ("ln1_s", "ln1_b", "wqkv", "bqkv", "rel_bias", "wproj", "bproj",
        "ln2_s", "ln2_b", "w1", "b1", "w2", "b2")


def _make_args(rng, C, nH):
    """Row-major ([in, out]) fp32 numpy weights, as the JAX tests make them."""
    A = lambda *s: (rng.standard_normal(s) * 0.05).astype(np.float32)
    return dict(
        ln1_s=rng.uniform(0.5, 1.5, C).astype(np.float32), ln1_b=A(C),
        wqkv=A(C, 3 * C), bqkv=A(3 * C), rel_bias=A(nH, N, N),
        wproj=A(C, C), bproj=A(C),
        ln2_s=rng.uniform(0.5, 1.5, C).astype(np.float32), ln2_b=A(C),
        w1=A(C, 4 * C), b1=A(4 * C), w2=A(4 * C, C), b2=A(C),
    )


def _port_args(args, dtype):
    """The port's argument order and layout: wqkv/w1/w2 as [out, in]."""
    out = []
    for k in KEYS:
        t = torch.from_numpy(args[k].T.copy() if k in ("wqkv", "w1", "w2") else args[k])
        out.append(t.to(dtype) if k in ("wqkv", "wproj", "w1", "w2") else t)
    return out


def _jax_args(args, dtype):
    out = []
    for k in KEYS:
        a = jnp.asarray(args[k].T if k in ("wqkv", "w1", "w2") else args[k])
        out.append(a.astype(dtype) if k in ("wqkv", "wproj", "w1", "w2") else a)
    return out


def _mask(rng, Wt):
    m = (rng.uniform(size=(N, Wt)) > 0.3).astype(np.float32)
    m[:, 0] = 1.0  # one fully real window
    return m


@pytest.mark.parametrize("masked", [False, True], ids=["tiled", "padmask"])
@pytest.mark.parametrize("C,nH", SIGNATURES)
def test_plain_fp32_matches_jax_kernel_and_reference(C, nH, masked):
    rng = np.random.default_rng(C * 13 + nH + masked)
    Wt = 10
    x = rng.standard_normal((C, N, Wt)).astype(np.float32)
    args = _make_args(rng, C, nH)
    mask = _mask(rng, Wt) if masked else None

    got = sb.swin_block_plain(
        torch.from_numpy(x), *_port_args(args, torch.float32), num_heads=nH,
        pad_mask=None if mask is None else torch.from_numpy(mask),
    ).numpy()
    want = np.asarray(jax_cst(
        jnp.asarray(x), *_jax_args(args, jnp.float32), num_heads=nH,
        pad_mask=None if mask is None else jnp.asarray(mask),
        block_windows=8, score_chunk=min(8, C // nH), interpret=True,
    ))
    tol = 1e-5 * np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)

    if not masked:  # the row-major reference has the same math
        x2 = x.transpose(2, 1, 0).reshape(Wt * N, C)
        ref = np.asarray(swin_block_reference(
            jnp.asarray(x2), *[jnp.asarray(args[k]) for k in KEYS], num_heads=nH, window_tokens=N,
        )).reshape(Wt, N, C).transpose(2, 1, 0)
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("C,nH", [(48, 3), (12, 3)])
def test_plain_bf16_error_bounded(C, nH):
    """bf16 deviation from the fp32 truth stays within the JAX kernel test's
    bound, and the bf16 plain version agrees with the JAX kernel in bf16."""
    rng = np.random.default_rng(C)
    Wt = 16
    x = rng.standard_normal((C, N, Wt)).astype(np.float32)
    args = _make_args(rng, C, nH)
    ref32 = sb.swin_block_plain(torch.from_numpy(x), *_port_args(args, torch.float32), num_heads=nH).numpy()
    got = sb.swin_block_plain(
        torch.from_numpy(x).bfloat16(), *_port_args(args, torch.bfloat16), num_heads=nH
    ).float().numpy()
    scale = np.abs(ref32).max()
    assert np.abs(got - ref32).max() < 0.05 * scale + 0.05

    jx = np.asarray(jax_cst(
        jnp.asarray(x).astype(jnp.bfloat16), *_jax_args(args, jnp.bfloat16), num_heads=nH,
        block_windows=8, score_chunk=min(8, C // nH), interpret=True,
    ), np.float32)
    np.testing.assert_allclose(got, jx, rtol=0, atol=1e-2 * np.abs(jx).max())


def test_wrapper_on_cpu_runs_plain_on_any_layout():
    """The wrapper takes any strides: a [C, N, Wt] view of token-major
    windows gives what the channels-major array gives. On a CPU tensor it
    runs the plain version and launches nothing."""
    rng = np.random.default_rng(3)
    C, nH, Wt = 24, 3, 12
    x = rng.standard_normal((C, N, Wt)).astype(np.float32)
    targs = _port_args(_make_args(rng, C, nH), torch.float32)
    sb.reset_counts()
    a = sb.fused_swin_block_cst(torch.from_numpy(x), *targs, num_heads=nH)
    tok = torch.from_numpy(x.transpose(2, 1, 0).copy())  # [Wt, N, C]
    b = sb.fused_swin_block_cst(tok.permute(2, 1, 0), *targs, num_heads=nH)
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert (sb.fused_swin_block_cst.launches, sb.fused_swin_block_cst.plain_calls) == (0, 2)


def test_wrapper_rejects_bad_operands():
    rng = np.random.default_rng(4)
    C, nH, Wt = 12, 3, 4
    x = torch.from_numpy(rng.standard_normal((C, N, Wt)).astype(np.float32))
    targs = _port_args(_make_args(rng, C, nH), torch.float32)
    with pytest.raises(ValueError, match="wqkv_t"):
        bad = list(targs)
        bad[2] = bad[2].bfloat16()  # weight dtype differs from x
        sb.fused_swin_block_cst(x, *bad, num_heads=nH)
    with pytest.raises(ValueError, match="rel_bias"):
        bad = list(targs)
        bad[4] = bad[4][:2]
        sb.fused_swin_block_cst(x, *bad, num_heads=nH)
    with pytest.raises(ValueError, match="pad_mask"):
        sb.fused_swin_block_cst(x, *targs, num_heads=nH, pad_mask=torch.ones(N, Wt + 1))
    with pytest.raises(TypeError):
        sb.fused_swin_block_cst(x.half(), *targs, num_heads=nH)
