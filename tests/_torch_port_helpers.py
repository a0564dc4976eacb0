"""Shared set-up of the tests/test_torch_port_*.py files: the small
SwinWNet geometry, JAX params drawn with numpy from a seed, and the
max-relative-error check of tests/test_torch_parity.py."""

import jax
import numpy as np
import torch

from swinwnet_tpu.models import SwinWNet as JaxSwinWNet
from swinwnet_tpu_torch.compat import state_dict_from_jax
from swinwnet_tpu_torch.models import SwinWNet as TorchSwinWNet

# 50x60 input -> 25x30 tokens (window padding from L1 down). B=5 gives the
# L0 and SR-head levels >= 128 windows, so they route to the kernel wrapper
# (its plain version on the CPU) as at the detector geometry.
H, W = 50, 60
BATCH = 5
CFG = dict(patch_size=2, in_chans=1, error_matrix=True, embed_dim=48,
           depths=(2, 2, 2, 2), num_heads=(3, 6, 12, 24), window_size=5)


def jax_params(seed=0, gamma=0.5):
    """Random JAX params for the small SwinWNet, drawn with numpy; the four
    cross-attention gammas are set to `gamma` so that those blocks are live."""
    model = JaxSwinWNet(**CFG)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), np.zeros((1, 2, H, W), np.float32))
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = str(path[-1].key)
        shape = leaf.shape
        if name == "gamma":
            return np.full(shape, gamma, np.float32)
        if name == "scale":
            return (1.0 + 0.1 * rng.standard_normal(shape)).astype(np.float32)
        if name in ("kernel", "proj_kernel", "in_proj_kernel"):
            fan_in = int(np.prod(shape[:-1]))
            return (rng.standard_normal(shape) / np.sqrt(fan_in)).astype(np.float32)
        return (0.05 * rng.standard_normal(shape)).astype(np.float32)  # biases, rel-pos tables

    return jax.tree_util.tree_map_with_path(draw, shapes)


def models(seed=0):
    """(JAX model, JAX variables, port model on the CPU with the same weights)."""
    params = jax_params(seed)
    port = TorchSwinWNet(**CFG, fused_blocks=True, device="cpu")
    port.load_state_dict(state_dict_from_jax(params), strict=True)
    return JaxSwinWNet(**CFG), params, port


def images(seed=0, batch=BATCH):
    return np.random.default_rng(seed).uniform(0, 1e3, (batch, 2, H, W)).astype(np.float32)


def assert_close(got, want, tol=2e-4, name=""):
    """Max absolute error relative to max|want| below `tol`."""
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, f"{name}: {got.shape} vs {want.shape}"
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-6)
    assert err < tol, f"{name}: max rel err {err:.3e}"
