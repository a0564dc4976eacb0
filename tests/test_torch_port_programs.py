"""The port's compiled serving programs (swinwnet_tpu_torch/core/graphs.py,
`make_inference_fn`, `make_split_inference_fn`, `make_rl_inference_fn`)
against the JAX package's functions of the same names, on the same numpy
images and the same weights, at a tiny geometry (embed 12, depths 1-1-1-1,
heads 3-6-12-24, window 5, 40x40, error matrix, live cross-attention), fp32.
On the CPU a program is its function run eagerly: these cases hold the
factories' wiring and what a program keys its graphs on; the cases marked
`cuda` capture and replay on the card (`python -m pytest --noconftest
tests/test_torch_port_programs.py -m cuda`; JAX is imported inside the
tests that use it, so the card, which has none, can run the file).

Tolerance against JAX: max absolute error at most 1e-5 of each stage's
max|JAX|, the pipeline tests' limit for the low-resolution stages
(tests/test_torch_port_split.py; observed here 4.3e-7 there and 3.2e-6 to
4.1e-6 from the upscaler on, whose tiny SR head amplifies the
summation-order noise)."""

import numpy as np
import pytest
import torch

from swinwnet_tpu_torch.core import graphs
from swinwnet_tpu_torch.models import AlphaPolicy, SwinWNet
from swinwnet_tpu_torch.ops import swin_block as sb
from swinwnet_tpu_torch.pipelines import (
    STAGE_NAMES,
    RLInference,
    SwinWNetInference,
    inference_stages,
    make_inference_fn,
    make_rl_inference_fn,
    make_split_inference_fn,
)

torch.set_num_threads(1)

TINY = dict(patch_size=2, in_chans=1, error_matrix=True, embed_dim=12, depths=(1, 1, 1, 1),
            num_heads=(3, 6, 12, 24), window_size=5)
S = 40
TOL = 1e-5


def close(got, want, name):
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy()
    assert got.shape == want.shape, name
    tol = TOL * max(np.abs(want).max(), 1e-6)
    assert np.abs(got - want).max() <= tol, f"{name}: {np.abs(got - want).max():.3e} > {tol:.3e}"


@pytest.fixture(scope="module")
def setup():
    import _torch_port_helpers as h
    from swinwnet_tpu.models import SwinWNet as JaxSwinWNet
    from swinwnet_tpu_torch.compat import state_dict_from_jax

    jmodel = JaxSwinWNet(**TINY)
    params = h.draw_params(jmodel, (1, 2, S, S), seed=9)
    port = SwinWNet(**TINY, device="cpu")
    port.load_state_dict(state_dict_from_jax(params), strict=True)
    x = np.random.default_rng(9).uniform(0, 1e3, (2, 1, S, S)).astype(np.float32)
    return jmodel, params, port, x


@pytest.mark.parametrize("factory", ["make_inference_fn", "make_split_inference_fn"])
def test_serving_program_matches_jax(setup, factory):
    import jax
    from swinwnet_tpu.pipelines.inference import make_inference_fn as jax_inference_fn
    from swinwnet_tpu.pipelines.split import make_split_inference_fn as jax_split_fn

    jmodel, params, port, x = setup
    jax_fn = {"make_inference_fn": jax_inference_fn, "make_split_inference_fn": jax_split_fn}[factory]
    want = jax.device_get(jax_fn(jmodel)(params, x))
    got = {"make_inference_fn": make_inference_fn, "make_split_inference_fn": make_split_inference_fn}[factory](
        port)(torch.from_numpy(x))
    assert list(got) == list(STAGE_NAMES)
    for name in STAGE_NAMES:
        close(got[name], want[name], name)


def test_rl_program_matches_jax(setup):
    import jax
    import jax.numpy as jnp
    from swinwnet_tpu.models import AlphaPolicy as JaxAlphaPolicy
    from swinwnet_tpu.pipelines.rl_inference import make_rl_inference_fn as jax_rl_fn
    from swinwnet_tpu_torch.compat import state_dict_from_jax

    jmodel, params, port, x = setup
    pp = JaxAlphaPolicy().init(jax.random.PRNGKey(4), jnp.zeros((1, 2, S, S)))
    policy = AlphaPolicy(device="cpu")
    policy.load_state_dict(state_dict_from_jax(pp), strict=True)
    want = jax.device_get(jax_rl_fn(jmodel, JaxAlphaPolicy())(params, pp, x))
    got = make_rl_inference_fn(port, policy)(torch.from_numpy(x))
    assert set(got) == set(STAGE_NAMES) | {"alpha"}
    for name in got:
        close(got[name], want[name], name)


def test_split_program_equals_the_single_program_bit_for_bit(setup):
    _, _, port, x = setup
    split, single = make_split_inference_fn(port), make_inference_fn(port)
    a, b = split(torch.from_numpy(x)), single(torch.from_numpy(x))
    assert all(torch.equal(a[k], b[k]) for k in STAGE_NAMES)
    assert isinstance(split.stage_a, graphs.Program) and isinstance(split.stage_c, graphs.Program)
    assert torch.equal(split.stage_a(torch.from_numpy(x))[1], b["seg_map_lr"])


def test_two_calls_return_distinct_tensors(setup):
    _, _, port, x = setup
    fn = make_inference_fn(port)
    a = fn(torch.from_numpy(x))
    kept = {k: v.clone() for k, v in a.items()}
    b = fn(torch.from_numpy(x[::-1].copy()))
    for k in STAGE_NAMES:
        assert a[k].data_ptr() != b[k].data_ptr(), k
        assert torch.equal(a[k], kept[k]), k


def test_callers_go_through_the_programs(setup):
    from swinwnet_tpu_torch.evalharness import MetricsCalculator

    _, _, port, x = setup
    infer = SwinWNetInference(port)
    assert isinstance(infer._fn, graphs.Program)
    assert isinstance(RLInference(port, AlphaPolicy(device="cpu"))._fn, graphs.Program)
    assert isinstance(MetricsCalculator(port, None, verbose=False)._infer, graphs.Program)
    out = infer(x)
    assert torch.equal(out, inference_stages(port, torch.from_numpy(x))["images_masked_hr"])


def test_the_key_follows_weights_parameters_and_configuration(setup):
    """What a graph reads besides its inputs: load_state_dict copies in
    place (same key), a replaced Parameter, a moved model or another compute
    dtype changes the key, and a replaced submodule is seen."""
    _, _, port, _ = setup
    model = SwinWNet(**TINY, device="cpu")
    model.load_state_dict(port.state_dict())
    watch = graphs._Watch([model])
    k0 = watch.key()
    model.load_state_dict(SwinWNet(**TINY, device="cpu", generator=torch.Generator().manual_seed(3)).state_dict())
    assert watch.key() == k0
    model.patch_embed.proj.weight = torch.nn.Parameter(model.patch_embed.proj.weight.detach().clone())
    k1 = watch.key()
    assert k1 != k0
    from swinwnet_tpu_torch.train.trainers import compute_dtype_of

    with compute_dtype_of(model, torch.bfloat16):
        assert watch.key() != k1
    assert watch.key() == k1
    model.seg_head = torch.nn.Linear(2, 2)
    assert watch.key() != k1


def test_programs_are_freed_without_the_garbage_collector():
    """A program held only by a reference cycle is freed whenever the
    garbage collector runs, a capture included, where destroying its graph
    ends the capture: no factory or caller makes such a cycle."""
    import gc

    from swinwnet_tpu_torch.train import FullModelTrainer, SegmentatorTrainer, UpscalerTrainer

    count = lambda: sum(isinstance(o, graphs.Program) for o in gc.get_objects())

    def build():
        model = SwinWNet(**TINY, device="cpu")
        make_split_inference_fn(model), SwinWNetInference(model, split=True), RLInference(model, AlphaPolicy(device="cpu"))
        for cls in (SegmentatorTrainer, UpscalerTrainer, FullModelTrainer):
            cls(model, [None], verbose=False)

    gc.collect()
    before = count()
    gc.disable()
    try:
        build()
        assert count() == before
    finally:
        gc.enable()


def test_cpu_program_is_the_eager_function_and_run_eagerly_nests():
    calls = []
    prog = graphs.Program(lambda x, k=1: calls.append(x) or x * k)
    t = torch.ones(3)
    assert torch.equal(prog(t), t) and calls == [t] and prog.num_graphs == 0
    with graphs.run_eagerly():
        with graphs.run_eagerly():
            assert graphs._local.eager == 2
        assert graphs._local.eager == 1
    assert graphs._local.eager == 0


def test_flatten_round_trips_the_pipelines_trees():
    tree = (torch.ones(2), {"x_min": torch.zeros(1), "threshold": 0.01}, [torch.ones(1), torch.ones(2)])
    leaves = []
    struct = graphs._flatten(tree, leaves)
    assert len(leaves) == 5 and hash(struct) is not None
    back = graphs._unflatten(struct, iter(leaves))
    assert isinstance(back[1], dict) and isinstance(back[2], list) and back[1]["threshold"] == 0.01


# ---- on the card: capture, replay, launch counts ----


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def card_model(dtype, seed=0):
    return SwinWNet(**TINY, fused_blocks=True, dtype=dtype, device="cuda", generator=torch.Generator().manual_seed(seed))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_replay_gives_the_eager_result_and_fresh_tensors(cuda, monkeypatch, dtype):
    from swinwnet_tpu_torch.models import BasicLayer

    monkeypatch.setattr(BasicLayer, "min_windows", 1)
    model = card_model(dtype).eval()
    fn = make_inference_fn(model)
    rng = np.random.default_rng(0)
    x1, x2 = (torch.from_numpy(rng.uniform(0, 1e3, (2, 2, S, S)).astype(np.float32)).to(cuda) for _ in range(2))
    fn(x1)
    before = [k.launches for k in sb.KERNELS]
    a = fn(x1)
    torch.cuda.synchronize()
    per_replay = [k.launches - b for k, b in zip(sb.KERNELS, before)]
    eager = inference_stages(model, x1)
    kept = {k: v.clone() for k, v in a.items()}
    b = fn(x2)
    assert fn.num_graphs == 1 and sum(per_replay) > 0
    for k in STAGE_NAMES:
        assert torch.equal(a[k], eager[k]), k
        assert torch.equal(a[k], kept[k]) and a[k].data_ptr() != b[k].data_ptr(), k
    assert torch.equal(b["images_masked_hr"], inference_stages(model, x2)["images_masked_hr"])
    fn(x1[:1])
    assert fn.num_graphs == 2


@pytest.mark.cuda
def test_a_replaced_parameter_captures_again(cuda):
    model = card_model(torch.float32).eval()
    fn = make_inference_fn(model)
    x = torch.rand(1, 2, S, S, device=cuda) * 1e3
    fn(x)
    model.patch_embed.proj.weight = torch.nn.Parameter(model.patch_embed.proj.weight.detach() * 1.5)
    out = fn(x)
    assert fn.num_graphs == 2
    assert torch.equal(out["images_masked_hr"], inference_stages(model, x)["images_masked_hr"])
