"""The port's fused-kernel gate (`BasicLayer.fused_route`) against the JAX
package's (`swinwnet_tpu/models/layers.py:793-811`), over width, compute
dtype, window count, `fused_deep`, `fused_layout` and padded grids.

The JAX route is read from the traced program with the backend reported as
"tpu" and the routing environment variables set by monkeypatch: the name of
the jitted entry point under the custom-VJP call tells the kernel. The port
takes the same choices as constructor arguments and reads no environment
variable; its route must not depend on `model.train()`.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swinwnet_tpu.models import BasicLayer as JaxBasicLayer
from swinwnet_tpu_torch.models import BasicLayer, init_weights
from swinwnet_tpu_torch.ops import swin_block as sb

torch.set_num_threads(1)

JAX_ENTRY_TO_ROUTE = {"fused_swin_block_cst": "cmajor", "fused_swin_block": "rowmajor",
                      "fused_swin_block_wide": "nmajor"}
ROUTE_TO_ENTRY = {"cmajor": sb.fused_swin_block_cst, "rowmajor": sb.fused_swin_block,
                  "nmajor": sb.fused_swin_block_wide}

# (C, nH, dtype, B, grid, fused_deep, fused_layout)
CASES = [
    # the cases of test_fused_gate_routing_matrix, and their B=2 twins over 128 windows
    (48, 3, "float32", 1, (50, 60), False, "cmajor"),
    (48, 3, "float32", 1, (10, 15), False, "cmajor"),
    (96, 6, "float32", 1, (50, 60), False, "cmajor"),
    (96, 6, "bfloat16", 1, (50, 60), False, "cmajor"),
    (48, 3, "float32", 2, (50, 60), False, "cmajor"),
    (96, 6, "float32", 2, (50, 60), False, "cmajor"),
    (96, 6, "bfloat16", 2, (50, 60), False, "cmajor"),
    # fused_deep: above the cap to the row-major kernel, up to C = 384, padded grids too
    (96, 6, "float32", 2, (50, 60), True, "cmajor"),
    (192, 12, "float32", 8, (32, 60), True, "cmajor"),
    (192, 12, "bfloat16", 8, (32, 60), True, "cmajor"),
    (384, 24, "float32", 8, (16, 30), True, "cmajor"),
    (384, 24, "float32", 5, (16, 30), True, "cmajor"),  # 120 windows
    (768, 24, "float32", 8, (16, 30), True, "cmajor"),
    (48, 3, "float32", 2, (50, 60), True, "cmajor"),  # under the cap: still cmajor
    # fused_layout = nmajor: under the cap on tiling grids, unfused on padded ones
    (48, 3, "float32", 2, (50, 60), False, "nmajor"),
    (12, 3, "float32", 1, (100, 120), False, "nmajor"),
    (96, 3, "bfloat16", 2, (50, 60), False, "nmajor"),
    (96, 6, "bfloat16", 4, (32, 60), False, "nmajor"),  # padded: falls back
    (24, 3, "float32", 4, (63, 120), True, "nmajor"),  # padded: falls back
    (192, 12, "float32", 8, (32, 60), True, "nmajor"),  # above the cap: row-major
    (24, 3, "bfloat16", 1, (55, 60), False, "cmajor"),  # padded cmajor keeps the kernel
]


def jax_route(monkeypatch, C, nH, dtype, B, grid, fused_deep, fused_layout):
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    layer = JaxBasicLayer(dim=C, depth=1, num_heads=nH, window_size=5, use_pallas=True, dtype=jdt)
    x = jnp.zeros((B, *grid, C), jdt)
    variables = jax.eval_shape(layer.init, jax.random.PRNGKey(0), x)
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    monkeypatch.delenv("SWINWNET_FUSED_INTERPRET", raising=False)
    monkeypatch.setenv("SWINWNET_FUSED_DEEP", "1" if fused_deep else "0")
    monkeypatch.setenv("SWINWNET_FUSED_LAYOUT", fused_layout)
    jaxpr = str(jax.make_jaxpr(lambda v, a: layer.apply(v, a))(variables, x))
    entries = set(re.findall(r"name=(fused_swin_block\w*)", jaxpr))
    assert ("pallas_call" in jaxpr) == bool(entries) and len(entries) <= 1
    return JAX_ENTRY_TO_ROUTE[entries.pop()] if entries else ""


@pytest.mark.parametrize("C,nH,dtype,B,grid,fused_deep,fused_layout", CASES)
def test_route_equals_jax_gate(monkeypatch, C, nH, dtype, B, grid, fused_deep, fused_layout):
    want = jax_route(monkeypatch, C, nH, dtype, B, grid, fused_deep, fused_layout)
    layer = BasicLayer(C, 1, nH, 5, fused_blocks=True, dtype=getattr(torch, dtype),
                       fused_deep=fused_deep, fused_layout=fused_layout)
    assert layer.fused_route(B, *grid) == want
    assert layer.uses_kernel(B, *grid) == (want != "")
    off = BasicLayer(C, 1, nH, 5, fused_blocks=False, dtype=getattr(torch, dtype),
                     fused_deep=fused_deep, fused_layout=fused_layout)
    assert off.fused_route(B, *grid) == ""


@pytest.mark.parametrize("C,nH,B,grid,fused_deep,fused_layout,route", [
    (12, 3, 2, (50, 60), False, "cmajor", "cmajor"),
    (12, 3, 2, (50, 60), False, "nmajor", "nmajor"),
    (96, 6, 6, (23, 31), True, "cmajor", "rowmajor"),
    (12, 3, 6, (23, 31), False, "nmajor", ""),
])
def test_forward_takes_the_route_in_train_and_eval(C, nH, B, grid, fused_deep, fused_layout, route):
    """The level runs through the entry point of its route (its plain
    version on the CPU), twice for depth 2, whether the module is in
    `train()` or `eval()`, with or without gradients; all routes agree
    with the unfused blocks."""
    layer = BasicLayer(C, 2, nH, 5, fused_blocks=True, fused_deep=fused_deep, fused_layout=fused_layout)
    init_weights(layer, torch.Generator().manual_seed(1))
    unfused = BasicLayer(C, 2, nH, 5, fused_blocks=False)
    unfused.load_state_dict(layer.state_dict())
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((B, *grid, C)).astype(np.float32))
    assert layer.fused_route(B, *grid) == route
    outs = []
    for mode, grad in (("eval", False), ("train", True), ("train", False)):
        getattr(layer, mode)()
        sb.reset_counts()
        with torch.set_grad_enabled(grad):
            outs.append(layer(x))
        want = [2 * int(route != "" and k is ROUTE_TO_ENTRY[route]) for k in sb.KERNELS]
        assert [k.plain_calls for k in sb.KERNELS] == want, mode
        assert outs[-1].requires_grad == grad
    np.testing.assert_array_equal(outs[0].numpy(), outs[1].detach().numpy())
    with torch.no_grad():
        ref = unfused(x)
    np.testing.assert_allclose(outs[0].numpy(), ref.numpy(), rtol=0, atol=1e-5 * float(ref.abs().max()))


def test_fused_layout_is_validated():
    with pytest.raises(ValueError, match="fused_layout"):
        BasicLayer(12, 1, 3, 5, fused_layout="rowmajor")


@pytest.mark.parametrize("C,nH,dtype,fused_deep,layout", [
    (30, 3, "float32", False, "cmajor"),  # head width 10
    (30, 3, "bfloat16", False, "nmajor"),
    (6, 3, "float32", False, "cmajor"),  # head width 2: the tiny model's SR level
    (120, 12, "float32", True, "cmajor"),  # head width 10 on the row-major route
    (96, 32, "bfloat16", False, "cmajor"),  # head width 3
])
def test_route_is_unfused_where_the_kernel_has_no_plan(C, nH, dtype, fused_deep, layout):
    """A level the JAX gate admits but the kernel has no plan for (a head
    width that is not a multiple of 4) goes to the unfused blocks, and its
    forward on the CPU equals theirs."""
    dt = getattr(torch, dtype)
    with pytest.raises(ValueError, match="head width"):
        sb.kernel_plan(C, nH, dt, round_qkv=C <= 96)
    layer = BasicLayer(C, 2, nH, 5, fused_blocks=True, dtype=dt, fused_deep=fused_deep, fused_layout=layout)
    assert layer.fused_route(4, 50, 60) == ""
    init_weights(layer, torch.Generator().manual_seed(2))
    unfused = BasicLayer(C, 2, nH, 5, fused_blocks=False, dtype=dt)
    unfused.load_state_dict(layer.state_dict())
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((4, 50, 60, C)).astype(np.float32)).to(dt)
    sb.reset_counts()
    with torch.no_grad():
        out = layer(x)
        np.testing.assert_array_equal(out.float().numpy(), unfused(x).float().numpy())
    assert [k.plain_calls for k in sb.KERNELS] == [0, 0, 0]


def test_model_with_a_level_the_kernel_refuses_runs_fused_on_the_cpu(monkeypatch):
    """The tiny model's SR head levels (6 and 3 wide, 3 heads) have head
    widths 2 and 1: with the window rule lowered, every other level goes to
    a wrapper, those two to the unfused blocks, and the whole forward equals
    the unfused model's."""
    from swinwnet_tpu_torch.models import SwinWNet

    monkeypatch.setattr(BasicLayer, "min_windows", 1)
    cfg = dict(embed_dim=12, depths=(1, 1, 1, 1), num_heads=(3, 3, 3, 3), error_matrix=True, device="cpu")
    fused = SwinWNet(**cfg, fused_blocks=True, fused_deep=True)
    plain = SwinWNet(**cfg, fused_blocks=False)
    plain.load_state_dict(fused.state_dict())
    head = fused.upscaler_head
    assert [blk.fused_route(1, 20, 30) for blk in (head.swin_blocks[0], head.swin_blocks[1])] == ["", ""]
    x = torch.from_numpy(np.random.default_rng(3).uniform(0, 1, (1, 2, 20, 30)).astype(np.float32))
    sb.reset_counts()
    with torch.no_grad():
        got, want = fused(x), plain(x)
    assert [k.plain_calls for k in sb.KERNELS] == [15, 12, 0]  # three tower passes of (5, 4)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0, atol=1e-5 * float(w.abs().max()))
