"""The port's SwinWNet in bf16 against the JAX package's in bf16, same
weights, same input, at the small geometry of tests/_torch_port_helpers.py
with the cross-attention live (gamma 0.5).

Two bf16 programs that round at the same points still differ by bf16 steps,
so a stage is not held to the JAX bf16 output directly: in the manner of
tests/test_swin_block_kernel.py:90-118 its error against the fp32 result
must be of the order of the JAX bf16 path's own error against it, no more
than `FACTOR` times that plus 1e-3 of the stage's range (observed ratios are
printed by the test). The dtypes that leave each stage must be the JAX
package's: its cross-attention returns fp32 in bf16 (`q + gamma * out` with
an fp32 gamma), so the two deepest skips are fp32 and the rest bf16.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_port_helpers as h
from swinwnet_tpu.models import SwinWNet as JaxSwinWNet
from swinwnet_tpu_torch.compat import state_dict_from_jax
from swinwnet_tpu_torch.models import CrossAttentionBlock, SwinWNet

torch.set_num_threads(1)

FACTOR = 2.0


def jax_stages(model, params, x):
    run = lambda m: jax.jit(lambda p, *a: model.apply(p, *a, method=m))
    seg, skips = run(JaxSwinWNet.segment_1)(params, x)
    up, skips_up = run(JaxSwinWNet.upscale)(params, x, skips)
    seg2, skips2 = run(JaxSwinWNet.segment_2)(params, up, skips_up)
    return dict(segment_1=seg, upscale=up, segment_2=seg2, skips=skips, skips_up=skips_up, skips_2=skips2)


@pytest.fixture(scope="module")
def staged():
    params = h.jax_params(seed=9)
    x = h.images(seed=9, batch=h.BATCH)
    ref = jax_stages(JaxSwinWNet(**h.CFG), params, x)
    jbf = jax_stages(JaxSwinWNet(**h.CFG, dtype=jnp.bfloat16), params, x)
    port = SwinWNet(**h.CFG, fused_blocks=True, dtype=torch.bfloat16, device="cpu")
    port.load_state_dict(state_dict_from_jax(params), strict=True)
    with torch.inference_mode():
        tx = torch.from_numpy(x)
        seg, skips = port.segment_1(tx)
        up, skips_up = port.upscale(tx, skips)
        seg2, skips2 = port.segment_2(up, skips_up)
    got = dict(segment_1=seg, upscale=up, segment_2=seg2, skips=skips, skips_up=skips_up, skips_2=skips2)
    return ref, jbf, got


def f32(a):
    return a.float().numpy() if isinstance(a, torch.Tensor) else np.asarray(a, np.float32)


@pytest.mark.parametrize("stage", ["segment_1", "upscale", "segment_2"])
def test_stage_error_bounded_by_the_jax_bf16_path(staged, stage):
    ref, jbf, got = staged
    want = f32(ref[stage])
    own = np.abs(f32(jbf[stage]) - want).max()
    err = np.abs(f32(got[stage]) - want).max()
    scale = np.abs(want).max()
    print(f"{stage}: port bf16 err {err:.3e}, JAX bf16 err {own:.3e}, ratio {err / own:.2f}, range {scale:.3e}")
    assert got[stage].shape == want.shape and np.isfinite(f32(got[stage])).all()
    assert err <= FACTOR * own + 1e-3 * scale


@pytest.mark.parametrize("which", ["skips", "skips_up", "skips_2"])
def test_skip_dtypes_and_errors(staged, which):
    ref, jbf, got = staged
    jdtypes = [str(s.dtype) for s in jbf[which]]
    assert [str(s.dtype).replace("torch.", "") for s in got[which]] == jdtypes
    if which != "skips":  # the two deepest went through the cross-attention
        assert jdtypes == ["bfloat16", "bfloat16", "float32", "float32"]
    for i, (r, j, g) in enumerate(zip(ref[which], jbf[which], got[which])):
        want = f32(r)
        own, err = np.abs(f32(j) - want).max(), np.abs(f32(g) - want).max()
        assert err <= FACTOR * own + 1e-3 * np.abs(want).max(), f"{which}[{i}]: {err:.3e} vs {own:.3e}"


def test_cross_attention_returns_fp32_in_bf16():
    blk = CrossAttentionBlock(12, 3, torch.bfloat16)
    torch.nn.init.normal_(blk.attn.in_proj_weight, std=0.1)
    torch.nn.init.zeros_(blk.attn.in_proj_bias)
    with torch.no_grad():
        blk.gamma.fill_(0.5)
    q = torch.randn(2, 7, 12, generator=torch.Generator().manual_seed(0)).bfloat16()
    out = blk(q, torch.randn(2, 5, 12, generator=torch.Generator().manual_seed(1)).bfloat16())
    assert out.dtype == torch.float32
    assert (out - q.float()).abs().max() > 0  # q + gamma * out, not rounded back to bf16
    assert not torch.equal(out, out.bfloat16().float())
