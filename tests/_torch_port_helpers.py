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


# the training tests' model: narrow and one block deep, so that the JAX steps
# compile in seconds; 20x30 inputs give 10x15 tokens (L1 down pads)
TINY = dict(patch_size=2, in_chans=1, error_matrix=True, embed_dim=12,
            depths=(1, 1, 1, 1), num_heads=(3, 3, 3, 3), window_size=5)
TINY_H, TINY_W = 20, 30


def jax_params(seed=0, gamma=0.5, cfg=None):
    """Random JAX params for the small SwinWNet (or `cfg`), drawn with numpy;
    the four cross-attention gammas are set to `gamma` so that those blocks
    are live."""
    return draw_params(JaxSwinWNet(**(cfg or CFG)), (1, 2, H, W), seed, gamma)


def draw_params(model, input_shape, seed=0, gamma=0.5):
    """Random params for the JAX `model` applied to `input_shape`, drawn with
    numpy: kernels N(0, 1/fan_in), LayerNorm scales near 1, the rest small;
    cross-attention gammas `gamma`."""
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), np.zeros(input_shape, np.float32))
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


def training_batches(n=2, batch=2, seed=0):
    """`n` (images [B, 2, h, w], masks [B, h, w]) numpy batches at the tiny
    training geometry."""
    rng = np.random.default_rng(seed)
    return [
        (rng.uniform(0, 1e3, (batch, 2, TINY_H, TINY_W)).astype(np.float32),
         (rng.uniform(size=(batch, TINY_H, TINY_W)) > 0.6).astype(np.float32))
        for _ in range(n)
    ]


def tiny_port(params, **kw):
    """The port's tiny model on the CPU with the JAX `params`, every level
    through the fused-block wrappers (fused_deep on)."""
    kw = {"fused_blocks": True, "fused_deep": True, **kw}
    port = TorchSwinWNet(**TINY, device="cpu", **kw)
    port.load_state_dict(state_dict_from_jax(params), strict=True)
    return port


def flat(tree):
    """Nested dict -> {"a/b/c": leaf}."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out["/".join(str(k.key) for k in path)] = np.asarray(leaf)
    return out


# the eval harness's tests: the tiny SwinWNet of the JAX package's own
# harness test (tests/test_evalharness.py) at 40x40, and batches of 2 from
# synthesize_dataset with their masks
HARNESS_CFG = dict(patch_size=2, in_chans=1, error_matrix=True, embed_dim=12, depths=(1, 1, 1, 1),
                   num_heads=(3, 6, 12, 24), window_size=5)
HARNESS_HW = 40


def harness_setup(seed=7, n=4, batch=2):
    """(JAX model, JAX params, port model on the CPU with the same weights,
    the JAX ArrayLoader, the port's ArrayLoader) over the same images."""
    from swinwnet_tpu.data import ArrayLoader as JaxArrayLoader
    from swinwnet_tpu_torch.data import ArrayLoader, synthesize_dataset

    jmodel = JaxSwinWNet(**HARNESS_CFG)
    params = draw_params(jmodel, (1, 2, HARNESS_HW, HARNESS_HW), seed)
    port = TorchSwinWNet(**HARNESS_CFG, device="cpu")
    port.load_state_dict(state_dict_from_jax(params), strict=True)
    images, masks = synthesize_dataset(n, H=HARNESS_HW, W=HARNESS_HW, seed=seed)
    return (jmodel, params, port, JaxArrayLoader(images, masks, batch_size=batch),
            ArrayLoader(images, masks, batch_size=batch))
