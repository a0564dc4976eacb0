"""The port's differentiable fused block (`fused_block_autodiff`, a
torch.autograd.Function: kernel forward, plain fp32 backward) against
`jax.grad` through the JAX package's `fused_block_autodiff` with its Pallas
kernels in interpret mode: the gradients of x and of every weight, for the
three layouts, in fp32 and bf16, with and without the pad mask.

Tolerance: 1e-4 * max|ref| per tensor in fp32 (both backwards differentiate
the same fp32 reference; sums in other orders). In bf16 both sides round x's
gradient and the four matrices' gradients to bf16 from fp32 values that
differ in their last bits, so a value near a rounding boundary lands one
bf16 step (2^-8 relative) apart: 1e-2 * max|ref| there.

In bf16 the JAX entry point's own backward raises (it hands an fp32
cotangent to a VJP whose output is bf16, swin_block.py:882), so the bf16
cases differentiate `_layout_xla_block`, the function that backward
recomputes, on the same bf16 operands.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swinwnet_tpu.ops.pallas.swin_block import _layout_xla_block as jax_layout_reference
from swinwnet_tpu.ops.pallas.swin_block import fused_block_autodiff as jax_autodiff
from swinwnet_tpu_torch.ops import swin_block as sb

import test_torch_port_swin_block_layouts as L

torch.set_num_threads(1)

N = 25
C, NH, WT = 24, 3, 8


def operands(layout, masked, seed):
    rng = np.random.default_rng(seed)
    x2 = rng.standard_normal((WT * N, C)).astype(np.float32)
    args = L.make_args(rng, C, NH)
    mask = None
    if masked:
        mask = (rng.uniform(size=(WT, N)) > 0.3).astype(np.float32)
        mask[0] = 1.0
    ct2 = rng.standard_normal((WT * N, C)).astype(np.float32)
    if layout == "cmajor":
        for k in ("wqkv", "w1", "w2"):  # [out, in] on this path
            args[k] = np.ascontiguousarray(args[k].T)
        lay = lambda a: np.ascontiguousarray(a.reshape(WT, N, C).transpose(2, 1, 0))
        mask = None if mask is None else np.ascontiguousarray(mask.T)
    elif layout == "nmajor":
        lay = lambda a: L.to_wide(a, WT)
    else:
        lay = lambda a: a
        mask = None if mask is None else mask.reshape(-1, 1)
    return lay(x2), lay(ct2), mask, args


CASES = [(lay, dt, m) for lay in ("cmajor", "rowmajor", "nmajor") for dt in ("float32", "bfloat16")
         for m in (False, True) if not (lay == "nmajor" and m)]


@pytest.mark.parametrize("layout,dtype,masked", CASES)
def test_gradients_match_jax_autodiff(layout, dtype, masked):
    x, ct, mask, args = operands(layout, masked, seed=len(layout) * 7 + masked)
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    tdt = getattr(torch, dtype)

    # JAX: the sum of out * ct, differentiated with respect to x and the weights
    jmask = () if mask is None else (jnp.asarray(mask),)

    def jloss(xj, *ws):
        if dtype == "float32":
            out = jax_autodiff(layout, NH, N, mask is not None, (8, True), xj, *jmask, *ws)
        else:
            out = jax_layout_reference(layout, NH, N, xj, jmask[0] if jmask else None, *ws)
        return jnp.sum(out.astype(jnp.float32) * jnp.asarray(ct))

    jx = jnp.asarray(x).astype(jdt)
    jws = L.jax_args(args, jdt)
    want = jax.grad(jloss, argnums=tuple(range(len(jws) + 1)))(jx, *jws)

    tx = torch.from_numpy(x).to(tdt).requires_grad_(True)
    tws = [t.requires_grad_(True) for t in L.port_args(args, tdt)]
    out = sb.fused_block_autodiff(layout, NH, tx, None if mask is None else torch.from_numpy(mask), *tws)
    assert out.dtype == tdt and out.shape == tx.shape
    (out.float() * torch.from_numpy(ct)).sum().backward()

    tol = 1e-4 if dtype == "float32" else 1e-2
    for name, t, w in zip(("x",) + L.KEYS, [tx] + tws, want):
        assert t.grad is not None and t.grad.dtype == t.dtype, name
        w = np.asarray(w, np.float32)
        scale = max(np.abs(w).max(), 1e-9)
        err = np.abs(t.grad.float().numpy() - w).max()
        assert err <= tol * scale, f"{name}: {err:.3e} vs {tol * scale:.3e}"


@pytest.mark.parametrize("layout", ["cmajor", "rowmajor", "nmajor"])
def test_forward_is_the_layouts_entry_point_and_saves_nothing_without_grad(layout):
    x, _, mask, args = operands(layout, layout != "nmajor", seed=3)
    tx = torch.from_numpy(x)
    tws = L.port_args(args, torch.float32)
    tmask = None if mask is None else torch.from_numpy(mask)
    entry = {"cmajor": sb.fused_swin_block_cst, "rowmajor": sb.fused_swin_block,
             "nmajor": sb.fused_swin_block_wide}[layout]
    sb.reset_counts()
    with torch.no_grad():
        out = sb.fused_block_autodiff(layout, NH, tx, tmask, *tws)
    assert out.grad_fn is None and not out.requires_grad
    assert [k.plain_calls for k in sb.KERNELS] == [int(k is entry) for k in sb.KERNELS]
    kw = {} if tmask is None else {"pad_mask": tmask}
    np.testing.assert_array_equal(out.numpy(), entry(tx, *tws, num_heads=NH, **kw).numpy())
    # with a gradient wanted only for x, the frozen weights get none
    tx.requires_grad_(True)
    sb.fused_block_autodiff(layout, NH, tx, tmask, *tws).sum().backward()
    assert tx.grad is not None and all(w.grad is None for w in tws)
