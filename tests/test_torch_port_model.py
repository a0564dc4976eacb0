"""The port's SwinWNet and BasicLayer (swinwnet_tpu_torch/models) against the
JAX package's, with the same weights (JAX params carried over by
`state_dict_from_jax`) at the small geometry of tests/_torch_port_helpers.py
in fp32, cross-attention live (gamma 0.5).

Staged parity tolerance: max relative error 2e-4, 5e-4 for segment_2, those
of tests/test_torch_parity.py:60-66,138.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_port_helpers as h
from swinwnet_tpu.models import BasicLayer as JaxBasicLayer
from swinwnet_tpu.models import SwinWNet as JaxSwinWNet
from swinwnet_tpu_torch.models import BasicLayer, init_weights
from swinwnet_tpu_torch.ops import swin_block as sb

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def staged():
    jmodel, params, port = h.models(seed=2)
    x = h.images(seed=2)

    def jit_method(m):
        return jax.jit(lambda p, *a: jmodel.apply(p, *a, method=m))

    jseg, jskips = jit_method(JaxSwinWNet.segment_1)(params, x)
    jup, jskips_up = jit_method(JaxSwinWNet.upscale)(params, x, jskips)
    jseg2, _ = jit_method(JaxSwinWNet.segment_2)(params, jup, jskips_up)

    with torch.inference_mode():
        tx = torch.from_numpy(x)
        tseg, tskips = port.segment_1(tx)
        tup, tskips_up = port.upscale(tx, tskips)
        tseg2, _ = port.segment_2(tup, tskips_up)
    return dict(
        segment_1=(tseg, jseg), upscale=(tup, jup), segment_2=(tseg2, jseg2),
        skips=(tskips, jskips), skips_up=(tskips_up, jskips_up),
    )


@pytest.mark.parametrize("stage,tol", [("segment_1", 2e-4), ("upscale", 2e-4), ("segment_2", 5e-4)])
def test_staged_forward(staged, stage, tol):
    got, want = staged[stage]
    h.assert_close(got, want, tol=tol, name=stage)


@pytest.mark.parametrize("which", ["skips", "skips_up"])
def test_skips(staged, which):
    """Encoder skip grids [B, h, w, C], the upscaler's after cross-attention."""
    got, want = staged[which]
    assert len(got) == len(want) == 4
    for i, (g, w) in enumerate(zip(got, want)):
        h.assert_close(g, w, name=f"{which}_{i}")


# (C, nH, dtype, B, grid): window counts just under and over 128, the
# fp32 / bf16 width caps, a padded grid, a deep level
ROUTES = [
    (48, 3, "float32", 1, (50, 60)),
    (48, 3, "float32", 2, (50, 60)),
    (96, 6, "float32", 2, (50, 60)),
    (96, 6, "bfloat16", 2, (50, 60)),
    (192, 12, "bfloat16", 2, (50, 60)),
    (12, 3, "float32", 1, (63, 120)),
    (24, 3, "bfloat16", 1, (50, 60)),
    (24, 3, "bfloat16", 1, (55, 60)),
]


@pytest.mark.parametrize("C,nH,dtype,B,grid", ROUTES)
def test_basic_layer_routes_as_jax_gate(monkeypatch, C, nH, dtype, B, grid):
    """The port's BasicLayer sends a level to the kernel wrapper exactly when
    the JAX package's gate would send it to fused_swin_block_cst on a TPU
    (read from the traced program with the backend reported as "tpu")."""
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    jlayer = JaxBasicLayer(dim=C, depth=1, num_heads=nH, window_size=5, use_pallas=True, dtype=jdt)
    x = jnp.zeros((B, *grid, C), jdt)
    # shapes only (the CPU backend traces the unfused path: the same tree)
    variables = jax.eval_shape(jlayer.init, jax.random.PRNGKey(0), x)
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    jaxpr = str(jax.make_jaxpr(lambda v, a: jlayer.apply(v, a))(variables, x))
    jax_fused = "pallas_call" in jaxpr

    tdt = getattr(torch, dtype)
    layer = BasicLayer(C, 1, nH, 5, fused_blocks=True, dtype=tdt).eval()
    sb.reset_counts()
    with torch.inference_mode():
        y = layer(torch.zeros(B, *grid, C, dtype=tdt))
    assert y.shape == (B, *grid, C)
    assert (sb.fused_swin_block_cst.plain_calls == 1) == jax_fused
    assert layer.uses_kernel(B, *grid) == jax_fused


def test_fused_and_unfused_layers_agree():
    """One BasicLayer with the wrapper (plain version on the CPU) against the
    unfused blocks, on a padded grid: pad slots zeroed after LN1 either way."""
    fused = BasicLayer(48, 2, 3, 5, fused_blocks=True).eval()
    init_weights(fused, torch.Generator().manual_seed(3))
    unfused = BasicLayer(48, 2, 3, 5, fused_blocks=False).eval()
    unfused.load_state_dict(fused.state_dict())
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((4, 23, 31, 48)).astype(np.float32))
    sb.reset_counts()
    with torch.inference_mode():
        a, b = fused(x), unfused(x)
    assert sb.fused_swin_block_cst.plain_calls == 2
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-5 * float(b.abs().max()))


def test_dropout_rates_of_zero_build_and_others_raise():
    """The JAX model's `drop`, `attn_drop` and `drop_path`: 0.0 (every
    recipe in the repo) builds; dropout itself is not ported yet, so any
    other rate raises."""
    from swinwnet_tpu_torch.models import SwinWNet

    cfg = dict(embed_dim=12, depths=(1, 1, 1, 1), num_heads=(3, 3, 3, 3), device="cpu")
    SwinWNet(**cfg, drop=0.0, attn_drop=0.0, drop_path=0.0)
    for name in ("drop", "attn_drop", "drop_path"):
        with pytest.raises(ValueError, match=name):
            SwinWNet(**cfg, **{name: 0.1})
