"""The port's `entry()` (swinwnet_tpu_torch/entry.py) against the JAX
`__graft_entry__.entry()`: the same model configuration and parameter count
(the JAX model's init run under `jax.eval_shape`, so nothing compiles at
full size), the same example image bit for bit, and, with the port's weights
carried into JAX by `convert_state_dict`, the same `images_masked_hr` at
[1, 2, 50, 60] within 1e-5 of its max (fp32 on both sides; observed about
3e-6 for the whole pipeline in tests/test_torch_port_pipeline.py)."""

import functools
import importlib.util
import inspect
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from swinwnet_tpu.compat import convert_state_dict
from swinwnet_tpu.models import SwinWNet as JaxSwinWNet
from swinwnet_tpu.pipelines.inference import inference_stages as jax_inference_stages
from swinwnet_tpu_torch import entry as port_entry
from swinwnet_tpu_torch import parallel
from swinwnet_tpu_torch.models.layers import BasicLayer

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
TOL = 1e-5


@pytest.fixture(scope="module")
def jax_entry():
    """The JAX entry()'s (model, abstract variables, x), its init under
    jax.eval_shape."""
    spec = importlib.util.spec_from_file_location("graft_entry", REPO / "__graft_entry__.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    init = JaxSwinWNet.init
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JaxSwinWNet, "init", lambda self, *a: jax.eval_shape(functools.partial(init, self), *a))
        fn, (variables, x) = mod.entry()
    return inspect.getclosurevars(fn).nonlocals["model"], variables, x


@pytest.fixture(scope="module")
def port():
    fn, (model, x) = port_entry.entry("cpu")
    return fn, model, x


def test_example_image_is_the_jax_one_bit_for_bit(jax_entry, port):
    _, _, want = jax_entry
    got = port[2]
    assert got.shape == (1, 2, 250, 480) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy().view(np.uint32), np.asarray(want).view(np.uint32))


def test_model_has_the_jax_configuration_and_parameter_count(jax_entry, port):
    jmodel, variables, _ = jax_entry
    _, model, _ = port
    assert (jmodel.in_chans, jmodel.error_matrix, jmodel.embed_dim, tuple(jmodel.depths),
            tuple(jmodel.num_heads), jmodel.window_size, jmodel.use_pallas) == (1, True, 48, (2, 2, 2, 2),
                                                                                  (3, 6, 12, 24), 5, False)
    want = jax.tree_util.tree_map(lambda a: a.shape, variables["params"])
    got = jax.tree_util.tree_map(lambda a: a.shape, convert_state_dict(model.state_dict()))
    assert got == want
    n_jax = sum(int(np.prod(a.shape)) for a in jax.tree_util.tree_leaves(variables["params"]))
    assert sum(p.numel() for p in model.parameters()) == n_jax
    levels = [m for m in model.modules() if isinstance(m, BasicLayer)]
    assert levels and not any(m.fused_blocks for m in levels)  # the JAX entry's use_pallas=False
    assert all(p.dtype == torch.float32 for p in model.parameters())


def test_fn_matches_jax_inference_stages(jax_entry, port):
    jmodel, _, _ = jax_entry
    fn, model, _ = port
    x = np.random.default_rng(1).uniform(0, 100, (1, 2, 50, 60)).astype(np.float32)
    got = fn(model, torch.from_numpy(x))
    want = np.asarray(jax.jit(functools.partial(jax_inference_stages, jmodel))(
        {"params": convert_state_dict(model.state_dict())}, x)["images_masked_hr"])
    assert got.shape == want.shape == (1, 2, 100, 120)
    assert np.abs(got.numpy() - want).max() <= TOL * np.abs(want).max()


def test_dryrun_multichip_is_reexported():
    assert port_entry.dryrun_multichip is parallel.dryrun_multichip


def test_entry_needs_a_card_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        port_entry.entry()


def test_main_prints_the_jax_line(monkeypatch, capsys):
    calls = []

    def stub(device=None):
        calls.append(device)
        return (lambda model, images: torch.zeros(1, 2, 500, 960)), (None, None)

    monkeypatch.setattr(port_entry, "entry", stub)
    port_entry.main(["--device", "cpu"])
    assert calls == ["cpu"] and capsys.readouterr().out == "entry ok: (1, 2, 500, 960)\n"
