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
