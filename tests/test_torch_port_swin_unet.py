"""The single-tower baselines (swinwnet_tpu_torch/models/swin_unet.py) and
their pipelines (pipelines/simple.py) against the JAX package's, on the same
numpy inputs and the same weights (JAX params carried over by
`state_dict_from_jax`), at a tiny geometry: embed 12, depths 1-1-1-1, heads
3-6-12-24, window 5, 40x40 images, fp32.

Tolerance: max absolute error at most 1e-5 of max|JAX output| (fp32 sums in
other orders; observed about 4e-7 on an x86 CPU), but for SwinUNetSR's output
through its head, 1e-4: at this width the head ends in LayerNorms over 6
and 3 channels and a 3-channel convolution, and it turns 1 ulp of noise on
its input (1.2e-7 relative) into up to 2.6e-5 of its output's max in the
port itself (measured), so the two packages' last-bit differences come out
at 2.3e-5 there. Its trunk, the decoder's output, is held at 1e-5. The
fused route is the port's kernel wrappers (their plain versions on the
CPU, the 128-window rule lowered) against JAX with `use_pallas=True` under
its interpret switch."""

import jax
import numpy as np
import pytest
import torch

import _torch_port_helpers as h
from swinwnet_tpu.compat import convert_state_dict
from swinwnet_tpu.models.swin_unet import SwinUNet as JaxSwinUNet
from swinwnet_tpu.models.swin_unet import SwinUNetSR as JaxSwinUNetSR
from swinwnet_tpu.pipelines.simple import make_segmentation_fn as jax_seg_fn
from swinwnet_tpu.pipelines.simple import make_sr_fn as jax_sr_fn
from swinwnet_tpu_torch.compat import jax_tree_from_state_dict, state_dict_from_jax
from swinwnet_tpu_torch.models import BasicLayer, SwinUNet, SwinUNetSR
from swinwnet_tpu_torch.ops import swin_block as sb
from swinwnet_tpu_torch.pipelines import make_segmentation_fn, make_sr_fn

torch.set_num_threads(1)

TINY = dict(patch_size=2, embed_dim=12, depths=(1, 1, 1, 1), num_heads=(3, 6, 12, 24), window_size=5)
S = 40
TOL = 1e-5
SR_HEAD_TOL = 1e-4
# name -> (JAX class, port class, input channels, output shape of a [2, c, 40, 40] batch)
MODELS = {
    "unet": (JaxSwinUNet, SwinUNet, 2, (2, 1, S, S)),
    "sr": (JaxSwinUNetSR, SwinUNetSR, 1, (2, 1, 2 * S, 2 * S)),
}


def setup(name, seed=0):
    jcls, pcls, c, _ = MODELS[name]
    params = h.draw_params(jcls(in_chans=c, **TINY), (1, c, S, S), seed)
    x = np.random.default_rng(seed).uniform(0, 1, (2, c, S, S)).astype(np.float32)
    return jcls, pcls, c, params, x


def port_model(pcls, c, params, **kw):
    port = pcls(in_chans=c, **TINY, device="cpu", **kw)
    port.load_state_dict(state_dict_from_jax(params), strict=True)
    return port


def close(got, want, tol=TOL):
    got, want = got.detach().float().numpy(), np.asarray(want, np.float32)
    assert got.shape == want.shape
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= tol, f"max abs err {err:.3e} of max|want|"


def jax_trunk(module, x):
    """The JAX tower's decoder output (the port's `trunk`)."""
    tokens, _ = module.patch_embed(x, scale_factor=1)
    skips = module.encoder(tokens)
    return module.decoder(module.bottleneck(skips[-1]), skips)


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("name", list(MODELS))
def test_forward_matches_jax(monkeypatch, name, fused):
    jcls, pcls, c, params, x = setup(name)
    if fused:
        monkeypatch.setenv("SWINWNET_FUSED_INTERPRET", "1")
        monkeypatch.setattr(BasicLayer, "min_windows", 1)
    jmodel = jcls(in_chans=c, **TINY, use_pallas=fused)
    want, want_trunk = jax.jit(lambda p, a: (jmodel.apply(p, a), jmodel.apply(p, a, method=jax_trunk)))(params, x)
    port = port_model(pcls, c, params, fused_blocks=fused)
    with torch.inference_mode():
        got_trunk, _ = port.trunk(torch.from_numpy(x))
        sb.reset_counts()
        got = port(torch.from_numpy(x))
    assert tuple(got.shape) == MODELS[name][3]
    # the levels of C <= 48 (the fp32 cap) whose head width the kernel takes
    # go to the wrapper, one block each: encoder L0-L2 (C 12, 24, 48) and the
    # decoder's last two stages (48, 24); the SR head's levels (head widths 2
    # and 1) stay on the unfused blocks
    assert sb.fused_swin_block_cst.plain_calls == (5 if fused else 0)
    close(got_trunk, want_trunk)
    close(got, want, SR_HEAD_TOL if name == "sr" else TOL)


@pytest.mark.parametrize("name", list(MODELS))
def test_weight_bridge_both_ways(name):
    """The port's state_dict converts to exactly the JAX tree (keys and
    shapes), and JAX params -> port -> JAX is bit exact both through the
    JAX package's converter and through the port's reverse bridge."""
    jcls, pcls, c, params, _ = setup(name, seed=3)
    shapes = jax.eval_shape(jcls(in_chans=c, **TINY).init, jax.random.PRNGKey(0),
                            np.zeros((1, c, S, S), np.float32))["params"]
    fresh = pcls(in_chans=c, **TINY, device="cpu", generator=torch.Generator().manual_seed(1))
    want = {p: l.shape for p, l in jax.tree_util.tree_flatten_with_path(shapes)[0]}
    got = {p: l.shape for p, l in jax.tree_util.tree_flatten_with_path(convert_state_dict(fresh.state_dict()))[0]}
    assert got == want
    head = "seg_head" if name == "unet" else "reconstruction"
    assert f"head.{head}.0.weight" in fresh.state_dict()

    port = port_model(pcls, c, params)
    a = jax.tree_util.tree_flatten_with_path(params["params"])[0]
    for back in (convert_state_dict(port.state_dict()), jax_tree_from_state_dict(port.state_dict())):
        b = dict(jax.tree_util.tree_flatten_with_path(back)[0])
        assert len(a) == len(b)
        for path, leaf in a:
            np.testing.assert_array_equal(np.asarray(leaf), b[path], err_msg=str(path))


def test_segmentation_fn_matches_jax():
    jcls, pcls, c, params, _ = setup("unet", seed=1)
    x = np.random.default_rng(1).uniform(0, 1e3, (2, c, S, S)).astype(np.float32)
    want = jax_seg_fn(jcls(in_chans=c, **TINY))(params, x)
    got = make_segmentation_fn(port_model(pcls, c, params))(x)
    assert got.device.type == "cpu" and not got.requires_grad
    close(got, want)


def test_sr_fn_matches_jax():
    """make_sr_fn normalizes, upscales and denormalizes, as the JAX one."""
    jcls, pcls, c, params, _ = setup("sr", seed=2)
    x = np.random.default_rng(2).uniform(0, 1e3, (2, c, S, S)).astype(np.float32)
    x *= np.random.default_rng(3).uniform(size=x.shape) > 0.7  # a masked pattern
    want = jax_sr_fn(jcls(in_chans=c, **TINY))(params, x)
    got = make_sr_fn(port_model(pcls, c, params))(x)
    assert tuple(got.shape) == (2, 1, 2 * S, 2 * S)
    close(got, want)


@pytest.mark.parametrize("rate", ["drop", "attn_drop", "drop_path"])
@pytest.mark.parametrize("name", list(MODELS))
def test_dropout_rates_other_than_zero_raise(name, rate):
    """Any rate builds; at the default deterministic=True the model computes
    what the rates-0 model does, and only deterministic=False drops."""
    _, pcls, c, _ = MODELS[name]
    x = torch.from_numpy(np.random.default_rng(5).uniform(0, 1e3, (2, c, S, S)).astype(np.float32))
    base = pcls(**TINY, in_chans=c, device="cpu", drop=0.0, attn_drop=0.0, drop_path=0.0)
    model = pcls(**TINY, in_chans=c, device="cpu", **{rate: 0.1})
    with torch.no_grad():
        want = base(x)
        assert torch.equal(model(x), want)
        assert not torch.equal(model(x, deterministic=False, generator=torch.Generator().manual_seed(5)), want)
