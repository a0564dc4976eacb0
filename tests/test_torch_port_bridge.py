"""The weight bridge between the port and the JAX package
(swinwnet_tpu_torch/compat): the port's state-dict names are the upstream
torch names, so the JAX package's `convert_state_dict` maps a port
`state_dict()` onto exactly the tree of `SwinWNet.init`; `state_dict_from_jax`
is its inverse, bit for bit."""

import jax
import numpy as np
import torch

import _torch_port_helpers as h
from swinwnet_tpu.compat import convert_state_dict
from swinwnet_tpu_torch.compat import (
    jax_tree_from_state_dict,
    load_pth,
    sniff_error_matrix,
    state_dict_from_jax,
    unwrap_state_dict,
)
from swinwnet_tpu_torch.models import SwinWNet

torch.set_num_threads(1)


def _paths(tree):
    return {"/".join(str(k.key) for k in p) for p, _ in jax.tree_util.tree_flatten_with_path(tree)[0]}


def test_port_state_dict_converts_to_the_jax_tree():
    port = SwinWNet(**h.CFG, device="cpu", generator=torch.Generator().manual_seed(0))
    converted = convert_state_dict(port.state_dict())
    shapes = jax.eval_shape(h.JaxSwinWNet(**h.CFG).init, jax.random.PRNGKey(0),
                            np.zeros((1, 2, h.H, h.W), np.float32))["params"]
    want, got = _paths(shapes), _paths(converted)
    assert want == got, f"missing: {sorted(want - got)[:5]} extra: {sorted(got - want)[:5]}"
    flat_want = dict(jax.tree_util.tree_flatten_with_path(shapes)[0])
    for path, leaf in jax.tree_util.tree_flatten_with_path(converted)[0]:
        assert leaf.shape == flat_want[path].shape, path


def test_jax_to_port_to_jax_is_bit_exact():
    params = h.jax_params(seed=4)
    sd = state_dict_from_jax(params)
    port = SwinWNet(**h.CFG, device="cpu")
    port.load_state_dict(sd, strict=True)
    back = convert_state_dict(port.state_dict())
    a = jax.tree_util.tree_flatten_with_path(params["params"])[0]
    b = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(a) == len(b)
    for path, leaf in a:
        np.testing.assert_array_equal(np.asarray(leaf), b[path], err_msg=str(path))


def test_load_pth_unwraps_and_sniffs(tmp_path):
    """An upstream-style checkpoint ({'state_dict': {'module.' + key: ...}})
    loads into the port with no key mapping."""
    src = SwinWNet(**h.CFG, device="cpu", generator=torch.Generator().manual_seed(5))
    path = tmp_path / "model.pth"
    torch.save({"state_dict": {"module." + k: v for k, v in src.state_dict().items()}, "epoch": 3}, path)
    sd = load_pth(str(path))
    assert not any(k.startswith("module.") for k in sd)
    assert sniff_error_matrix(sd)
    dst = SwinWNet(**h.CFG, device="cpu")
    dst.load_state_dict(sd, strict=True)
    for k, v in src.state_dict().items():
        assert torch.equal(dst.state_dict()[k], v), k

    single = SwinWNet(**{**h.CFG, "error_matrix": False}, device="cpu")
    assert not sniff_error_matrix(unwrap_state_dict({"model_state_dict": single.state_dict()}))


def test_port_names_back_to_the_jax_tree_bit_exact():
    """`jax_tree_from_state_dict` is the inverse of `state_dict_from_jax`:
    parameters (and anything keyed like them: gradients, moments) come back
    under the JAX names and layouts, bit for bit, without the index buffers."""
    params = h.jax_params(seed=6)["params"]
    port = SwinWNet(**h.CFG, device="cpu")
    port.load_state_dict(state_dict_from_jax(params), strict=True)
    for named in (port.state_dict(), dict(port.named_parameters())):
        back = jax_tree_from_state_dict(named)
        assert _paths(back) == _paths(params)
        flat = dict(jax.tree_util.tree_flatten_with_path(back)[0])
        for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
            np.testing.assert_array_equal(flat[path], np.asarray(leaf), err_msg=str(path))
