"""`remat` and `attn_chunk` in the port, as tests/test_modes.py checks them
in the JAX package (the same tiny model, inputs and tolerances: rtol 1e-4,
atol 1e-5, each against the port's own plain route), each also against the
JAX model within 1e-4 of max|want| (measured: segment_1 6e-7, upscale
3.9e-5, chunked or not on either side; elementwise rtol 1e-4 / atol 1e-5
misses 6 of upscale's 25600 elements): remat's segment_1, and the chunked
attention's segment_1 and upscale. Remat's gradients equal the
plain backward's within 1e-6 of each leaf's largest (the recompute repeats
the forward's arithmetic), it saves fewer activations for the backward, and
a fused level is left as it is (its autograd Function already keeps only
its input)."""

import jax
import numpy as np
import pytest
import torch

import _torch_port_helpers as h
from swinwnet_tpu.models import SwinWNet as JaxSwinWNet
from swinwnet_tpu_torch.compat import state_dict_from_jax
from swinwnet_tpu_torch.models import BasicLayer, SwinWNet
from swinwnet_tpu_torch.ops import swin_block as sb

torch.set_num_threads(1)

# tests/test_modes.py's TINY
MODES = dict(in_chans=1, error_matrix=True, embed_dim=12, depths=(1, 1, 1, 1), num_heads=(3, 6, 12, 24),
             window_size=5)


@pytest.fixture(scope="module")
def weights():
    return h.draw_params(JaxSwinWNet(**MODES), (1, 2, 40, 40), seed=21)


def port(weights, **kw):
    m = SwinWNet(**MODES, device="cpu", **kw)
    m.load_state_dict(state_dict_from_jax(weights), strict=True)
    return m


def test_remat_model_matches(weights):
    x = np.random.default_rng(0).normal(size=(1, 2, 40, 40)).astype(np.float32)
    jm = JaxSwinWNet(**MODES, remat=True)
    want, _ = jax.jit(lambda p, x: jm.apply(p, x, method=JaxSwinWNet.segment_1))(weights, x)
    plain, _ = port(weights).segment_1(torch.from_numpy(x))
    seg, _ = port(weights, remat=True).segment_1(torch.from_numpy(x))  # autograd on: checkpointed
    np.testing.assert_allclose(seg.detach().numpy(), plain.detach().numpy(), rtol=1e-4, atol=1e-5)
    h.assert_close(seg, want, tol=1e-4, name="remat segment_1 vs JAX")


def test_attn_chunk_matches_unchunked(weights):
    x = np.random.default_rng(1).normal(size=(2, 2, 40, 40)).astype(np.float32)
    jm = JaxSwinWNet(**MODES, attn_chunk=16)

    def jax_run(p, x):
        seg, skips = jm.apply(p, x, method=JaxSwinWNet.segment_1)
        return seg, jm.apply(p, x, skips, method=JaxSwinWNet.upscale)[0]

    want = jax.jit(jax_run)(weights, x)
    xt = torch.from_numpy(x)
    with torch.no_grad():
        outs = {}
        for chunk in (0, 16):
            m = port(weights, attn_chunk=chunk)
            seg, skips = m.segment_1(xt)
            outs[chunk] = (seg, m.upscale(xt, skips)[0])
    for i, name in enumerate(("segment_1", "upscale")):
        np.testing.assert_allclose(outs[16][i].numpy(), outs[0][i].numpy(), rtol=1e-4, atol=1e-5, err_msg=name)
        h.assert_close(outs[16][i], want[i], tol=1e-4, name=name + " vs JAX")


def test_attn_chunk_runs_in_chunks(monkeypatch):
    """L0 of a [2, 2, 40, 40] input is 2 x 16 windows: chunks of 16, the
    last ragged at 7 windows, and none for the masked shifted attention."""
    from swinwnet_tpu_torch.models.layers import WindowAttention

    sizes = []
    real = WindowAttention._attend
    monkeypatch.setattr(WindowAttention, "_attend", lambda self, x, *a: sizes.append(x.shape[0]) or real(self, x, *a))
    layer = BasicLayer(12, 1, 3, attn_chunk=16)
    with torch.no_grad():
        layer(torch.randn(2, 20, 20, 12))
        layer(torch.randn(1, 23, 23, 12))
        assert sizes == [16, 16, 16, 9]
        sizes.clear()
        BasicLayer(12, 1, 3, attn_chunk=16, shift_size=2)(torch.randn(2, 20, 20, 12))
        assert sizes == [32]


def _grads(model, x):
    model.zero_grad()
    seg, skips = model.segment_1(x)
    up, _ = model.upscale(x, skips)
    (seg.square().mean() + up.square().mean()).backward()
    return {k: p.grad.clone() for k, p in model.named_parameters() if p.grad is not None}


def test_remat_gradients_equal_the_plain_backward(weights):
    x = torch.from_numpy(np.random.default_rng(2).normal(size=(2, 2, 40, 40)).astype(np.float32))
    plain, remat = _grads(port(weights), x), _grads(port(weights, remat=True), x)
    assert plain.keys() == remat.keys() and len(plain) > 100
    for k, g in plain.items():
        np.testing.assert_allclose(remat[k].numpy(), g.numpy(), rtol=0, atol=1e-6 * float(g.abs().max()), err_msg=k)


def _saved_bytes(model, x):
    total = [0]

    def pack(t):
        total[0] += t.numel() * t.element_size()
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        model.segment_1(x)[0].sum()
    return total[0]


def test_remat_saves_less_for_the_backward(weights):
    x = torch.from_numpy(np.random.default_rng(3).normal(size=(2, 2, 40, 40)).astype(np.float32))
    plain, remat = _saved_bytes(port(weights), x), _saved_bytes(port(weights, remat=True), x)
    assert remat < 0.5 * plain, (remat, plain)


def test_remat_leaves_fused_levels_to_the_kernel(weights, monkeypatch):
    monkeypatch.setattr(BasicLayer, "min_windows", 1)
    x = torch.from_numpy(np.random.default_rng(4).normal(size=(2, 2, 40, 40)).astype(np.float32))
    counts = {}
    grads = {}
    for remat in (False, True):
        sb.reset_counts()
        grads[remat] = _grads(port(weights, fused_blocks=True, fused_deep=True, remat=remat), x)
        counts[remat] = [k.plain_calls for k in sb.KERNELS]
    assert counts[True] == counts[False] and sum(counts[True]) > 0
    for k, g in grads[False].items():
        np.testing.assert_allclose(grads[True][k].numpy(), g.numpy(), rtol=0, atol=1e-6 * float(g.abs().max()), err_msg=k)
