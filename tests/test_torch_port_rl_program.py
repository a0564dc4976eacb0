"""The port's REINFORCE step as a program (swinwnet_tpu_torch/train/rl.py:
`RLState`, `make_rl_train_step`, and `RLTrainer` stepping through it)
against the JAX package's `make_rl_train_step`, with the same weights
(carried over by `state_dict_from_jax`), images and noise, on the CPU in
fp32, at the tiny training model and the 160-bin grid of
tests/test_torch_port_rl.py.

* Three steps from one state on three batches of synthesized Bragg
  patterns, the port's noise the JAX step's own draws: every metric of
  every step within 1e-4 relative (the loss limit of the trainer tests), and
  every model and policy leaf after the third within 1e-3 of its max|JAX|;
  a key bias, whose gradient is summation noise in both, within what Adam
  can move it in three steps.
* The step reads nothing back from the device: `rl_step` runs with
  `Tensor.item`, `__int__`, `__float__`, `__bool__`, `tolist` and `numpy`
  raising (a CUDA graph cannot capture such a read).
* `RLTrainer` through the factory gives the history and the weights of
  `rl_step` stepped by hand with a generator of the same seed, bit for bit.
* On the card (marked `cuda`): four replays of the program against four
  eager `rl_step`s from the same weights and noise, bit for bit, the
  launches a replay equal to the eager step's.
"""

import contextlib

import numpy as np
import pytest
import torch

from swinwnet_tpu_torch.core import graphs
from swinwnet_tpu_torch.models import AlphaPolicy, BasicLayer, SwinWNet
from swinwnet_tpu_torch.ops import swin_block as sb
from swinwnet_tpu_torch.physics import Qwrapper
from swinwnet_tpu_torch.train import (
    AdamW,
    RLState,
    RLTrainer,
    TrainState,
    make_rl_train_step,
    masked_adamw,
    rl_step,
)
from swinwnet_tpu_torch.train import rl as rl_mod

torch.set_num_threads(1)

RL_H, RL_W = 60, 80
GRID = np.linspace(0.05, 7.49, 160)
MODEL_LR, POLICY_LR = 1e-4, 1e-4
STEPS = 3
LOSS_RTOL, LEAF_TOL = 1e-4, 1e-3
METRICS = ("reward", "rec", "integral", "peak", "shape", "alpha_mean", "alpha_std", "policy_loss", "sup_loss")
HOST_READS = ("item", "__int__", "__float__", "__bool__", "tolist", "numpy")


def bragg_images(offset=0, batch=2):
    """Synthesized patterns with eight broadened Bragg lines each (those of
    tests/test_torch_port_rl.py), shifted by `offset`."""
    from swinwnet_tpu.data.generation import synthesize_pattern

    lines = [1.0, 1.4, 1.9, 2.5, 3.1, 3.8, 4.4, 5.2]
    return np.stack([
        synthesize_pattern([d + 0.05 * i + 0.02 * offset for d in lines], [1.0] * len(lines), H=RL_H, W=RL_W,
                           seed=i + 10 * offset, resolution=0.05, pulse_width=0.1)[None]
        for i in range(batch)
    ]).astype(np.float32)


def port_pair(params, policy_params):
    import _torch_port_helpers as h
    from swinwnet_tpu_torch.compat import state_dict_from_jax

    port = h.tiny_port(params).train()
    policy = AlphaPolicy(device="cpu")
    policy.load_state_dict(state_dict_from_jax(policy_params), strict=True)
    return port, policy


def port_state(port, policy, seed=0):
    model_tx = masked_adamw(port, "rl", MODEL_LR, weight_decay=0.0)
    policy_tx = AdamW(policy.parameters(), POLICY_LR, weight_decay=0.0)
    state = RLState(TrainState.create(port, model_tx), TrainState.create(policy, policy_tx),
                    torch.Generator().manual_seed(seed))
    return state, model_tx, policy_tx


@pytest.fixture(scope="module")
def runs():
    """Three JAX steps (one compile) and three steps of the port's program
    fed the JAX step's noise."""
    import jax
    import jax.numpy as jnp
    import optax

    import _torch_port_helpers as h
    from swinwnet_tpu.models import AlphaPolicy as JaxAlphaPolicy
    from swinwnet_tpu.models import SwinWNet as JaxSwinWNet
    from swinwnet_tpu.physics.qwrapper import Qwrapper as JaxQwrapper
    from swinwnet_tpu.train.freeze import masked_adamw as jax_masked_adamw
    from swinwnet_tpu.train.rl import RLState as JaxRLState
    from swinwnet_tpu.train.rl import make_rl_train_step as jax_make_rl_train_step
    from swinwnet_tpu.train.trainers import TrainState as JaxTrainState
    from swinwnet_tpu_torch.compat import jax_tree_from_state_dict

    mp = pytest.MonkeyPatch()
    mp.setattr(BasicLayer, "min_windows", 1)
    try:
        params = h.jax_params(seed=2, cfg=h.TINY)["params"]
        pp = JaxAlphaPolicy().init(jax.random.PRNGKey(1), jnp.zeros((1, 2, RL_H // 2, RL_W // 2)))
        batches = [bragg_images(i) for i in range(STEPS)]
        model_tx, policy_tx = jax_masked_adamw(params, "rl", MODEL_LR, weight_decay=0.0), optax.adam(POLICY_LR)
        jstep = jax_make_rl_train_step(JaxSwinWNet(**h.TINY), JaxAlphaPolicy(), model_tx, policy_tx,
                                       JaxQwrapper(fixed_centers=GRID))
        jstate = JaxRLState(JaxTrainState.create(params, model_tx), JaxTrainState.create(pp["params"], policy_tx),
                            jax.random.PRNGKey(0))
        noises, jmetrics = [], []
        for images in batches:
            key = jax.random.split(jstate.rng)[1]  # the key the step draws its noise with
            noises.append(np.asarray(jax.random.normal(key, (len(images), 1))))
            jstate, m = jstep(jstate, images)
            jmetrics.append({k: float(v) for k, v in m.items()})

        port, policy = port_pair(params, pp["params"])
        state, model_tx, policy_tx = port_state(port, policy)
        step = make_rl_train_step(port, policy, model_tx, policy_tx, Qwrapper(fixed_centers=GRID, device="cpu"))
        fed = iter(noises)
        metrics, same_state = [], True
        with pytest.MonkeyPatch.context() as fed_noise:
            fed_noise.setattr(rl_mod, "draw_noise", lambda rng, batch, device: torch.from_numpy(next(fed)))
            for images in batches:
                new_state, m = step(state, images)
                same_state &= new_state is state
                metrics.append({k: float(v) for k, v in m.items()})
        yield dict(jmetrics=jmetrics, metrics=metrics, same_state=same_state, state=state,
                   jmodel=h.flat(jstate.model.params), jpolicy=h.flat(jstate.policy.params),
                   model=h.flat(jax_tree_from_state_dict(dict(port.named_parameters()))),
                   policy=h.flat(jax_tree_from_state_dict(dict(policy.named_parameters()))))
    finally:
        mp.undo()


@pytest.mark.parametrize("key", METRICS)
def test_program_metrics_match_jax(runs, key):
    for i, (got, want) in enumerate(zip(runs["metrics"], runs["jmetrics"])):
        assert np.isfinite(got[key]) and abs(got[key] - want[key]) <= LOSS_RTOL * abs(want[key]), \
            f"step {i}: {got[key]} vs {want[key]}"
    assert runs["jmetrics"][0]["reward"] < 0  # not vacuous: the reward is not 0


def within_leaf_tol(got, want, travel):
    """Each leaf within LEAF_TOL of its max|JAX|; a key bias (the middle
    third of a fused qkv bias), whose gradient is 0 in exact arithmetic and
    summation noise in either framework, within 2 * `travel`."""
    assert got.keys() == want.keys()
    for k, w in want.items():
        diff = np.abs(got[k] - w)
        if k.endswith("qkv/bias") or k.endswith("in_proj_bias"):
            c = w.shape[-1] // 3
            assert diff[..., c:2 * c].max() <= 2 * travel, k
            diff[..., c:2 * c] = 0.0
        assert diff.max() <= LEAF_TOL * max(np.abs(w).max(), 1e-6), f"{k}: {diff.max():.3e}"


def test_model_leaves_after_the_steps_match_jax(runs):
    within_leaf_tol(runs["model"], runs["jmodel"], STEPS * MODEL_LR)


def test_policy_leaves_after_the_steps_match_jax(runs):
    within_leaf_tol(runs["policy"], runs["jpolicy"], STEPS * POLICY_LR)


def test_state_is_updated_in_place_and_counts_steps(runs):
    state = runs["state"]
    assert runs["same_state"]
    assert int(state.model.step) == int(state.policy.step) == STEPS
    assert state.model.step is state.model.opt_state.count and state.policy.step is state.policy.opt_state.count
    assert all(name.startswith(("upscaler_", "ca_seg_to_sr")) for name in state.model.params)


def tiny_pair(seed=3):
    model = SwinWNet(patch_size=2, in_chans=1, error_matrix=True, embed_dim=12, depths=(1, 1, 1, 1),
                     num_heads=(3, 3, 3, 3), window_size=5, fused_blocks=True, device="cpu",
                     generator=torch.Generator().manual_seed(seed)).train()
    return model, AlphaPolicy(device="cpu", generator=torch.Generator().manual_seed(seed + 1))


def test_rl_step_reads_nothing_back_from_the_device(monkeypatch):
    """Every read that a CUDA graph cannot capture raises during the step."""
    model, policy = tiny_pair()
    state, model_tx, policy_tx = port_state(model, policy)
    qw = Qwrapper(fixed_centers=GRID, device="cpu")
    images = torch.from_numpy(bragg_images(0))
    noise = torch.randn((2, 1), generator=torch.Generator().manual_seed(0))

    def refuse(name):
        def read(*_, **__):
            raise AssertionError(f"a host read: Tensor.{name}")
        return read

    with monkeypatch.context() as mp:
        for name in HOST_READS:
            mp.setattr(torch.Tensor, name, refuse(name))
        m = rl_step(model, policy, model_tx, policy_tx, qw, images, noise)
    assert set(m) == set(METRICS) and all(np.isfinite(float(v)) for v in m.values())
    assert int(model_tx.count) == int(policy_tx.count) == 1


def test_trainer_through_the_factory_equals_rl_step_by_hand():
    """RLTrainer's history and weights are those of rl_step with noise from
    a generator of the trainer's seed, bit for bit."""
    batches = [bragg_images(0), bragg_images(1)]
    model, policy = tiny_pair()
    trainer = RLTrainer(model, policy, [(b,) for b in batches], d_centers=GRID, num_epochs=2, model_lr=MODEL_LR,
                        seed=5, verbose=False)
    history = trainer.fit()

    model2, policy2 = tiny_pair()
    state, model_tx, policy_tx = port_state(model2, policy2)
    gen = torch.Generator().manual_seed(5)
    qw = Qwrapper(fixed_centers=GRID, device="cpu")
    by_hand = []
    for _ in range(2):
        agg = dict.fromkeys(METRICS, 0.0)
        for b in batches:
            noise = torch.randn((len(b), 1), generator=gen)
            for k, v in rl_step(model2, policy2, model_tx, policy_tx, qw, torch.from_numpy(b), noise).items():
                agg[k] += float(v)
        by_hand.append({k: v / len(batches) for k, v in agg.items()})
    assert history == by_hand
    for (k, a), b in zip(model.state_dict().items(), model2.state_dict().values()):
        assert torch.equal(a, b), k
    for (k, a), b in zip(policy.state_dict().items(), policy2.state_dict().values()):
        assert torch.equal(a, b), k
    assert isinstance(trainer.state, RLState) and int(trainer.policy_opt.count) == 4


# ---- on the card ----


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("compute_dtype", [None, "bfloat16"])
def test_replayed_steps_equal_eager_steps(cuda, monkeypatch, compute_dtype):
    monkeypatch.setattr(BasicLayer, "min_windows", 1)
    rng = np.random.default_rng(0)
    batches = [torch.from_numpy(bragg_images(i)).to(cuda) * float(rng.uniform(1, 10)) for i in range(4)]
    runs = []
    for eager in (True, False):
        model = SwinWNet(patch_size=2, in_chans=1, error_matrix=True, embed_dim=12, depths=(1, 1, 1, 1),
                         num_heads=(3, 3, 3, 3), window_size=5, fused_blocks=True, device="cuda",
                         generator=torch.Generator().manual_seed(3)).train()
        policy = AlphaPolicy(device="cuda", generator=torch.Generator().manual_seed(4))
        model_tx = masked_adamw(model, "rl", MODEL_LR, weight_decay=0.0)
        policy_tx = AdamW(policy.parameters(), POLICY_LR, weight_decay=0.0)
        state = RLState(TrainState.create(model, model_tx), TrainState.create(policy, policy_tx),
                        torch.Generator(device="cuda").manual_seed(0))
        step = make_rl_train_step(model, policy, model_tx, policy_tx, Qwrapper(fixed_centers=GRID),
                                  compute_dtype=compute_dtype)
        metrics, counts = [], []
        with graphs.run_eagerly() if eager else contextlib.nullcontext():
            for images in batches:
                before = [k.launches for k in sb.KERNELS]
                metrics.append({k: float(v) for k, v in step(state, images)[1].items()})
                counts.append([k.launches - b for k, b in zip(sb.KERNELS, before)])
        leaves = {k: v.detach().clone() for k, v in [*model.state_dict().items(), *policy.state_dict().items()]}
        runs.append((metrics, counts, leaves))
    (e_metrics, e_counts, e_leaves), (metrics, counts, leaves) = runs
    assert metrics == e_metrics and counts == e_counts and sum(counts[0]) > 0
    assert all(torch.equal(leaves[k], v) for k, v in e_leaves.items())
