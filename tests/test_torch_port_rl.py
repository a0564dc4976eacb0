"""The port's REINFORCE fine-tune and RL serving (swinwnet_tpu_torch:
models/alpha_policy.py, pipelines/rl_inference.py, train/rl.py) against the
JAX package's, with the same weights (carried over by
`state_dict_from_jax`), images and noise, on the CPU in fp32.

* `AlphaPolicy` and `apply_action`: 1e-5 relative.
* `rl_inference_stages` at the geometry of tests/test_torch_port_pipeline.py
  and with its tolerances (2e-4 relative up to the policy, 5e-4 from the
  upscaler on; observed about 3e-6).
* One RL step against `make_rl_train_step` at the tiny training model on a
  160-bin grid (as tests/test_train.py::test_rl_step), on synthesized Bragg
  patterns whose reward is not 0 (with random weights a reward of exactly 0
  is common, and then the policy gradient is 0 and shows nothing): reward,
  policy loss, rec and sup loss within 1e-4 relative; the model's and the
  policy's gradients within 1e-3 of each leaf's largest (JAX's read back
  from Adam's first moment, as tests/_torch_port_train_helpers.py does); the
  segmentator unchanged. The JAX model runs its XLA blocks; the port sends
  every level the kernel has a plan for through the fused-block wrappers
  (the 128-window rule lowered), whose plain versions run on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import _torch_port_helpers as h
import _torch_port_train_helpers as th
from swinwnet_tpu.data.generation import synthesize_pattern
from swinwnet_tpu.models import AlphaPolicy as JaxAlphaPolicy
from swinwnet_tpu.models import SwinWNet as JaxSwinWNet
from swinwnet_tpu.models import apply_action as jax_apply_action
from swinwnet_tpu.physics.qwrapper import Qwrapper as JaxQwrapper
from swinwnet_tpu.pipelines.rl_inference import make_rl_inference_fn
from swinwnet_tpu.train.freeze import masked_adamw as jax_masked_adamw
from swinwnet_tpu.train.rl import RLState, make_rl_train_step
from swinwnet_tpu.train.trainers import TrainState
from swinwnet_tpu_torch.compat import jax_tree_from_state_dict, state_dict_from_jax
from swinwnet_tpu_torch.models import AlphaPolicy, BasicLayer, apply_action
from swinwnet_tpu_torch.ops import swin_block as sb
from swinwnet_tpu_torch.physics import Qwrapper
from swinwnet_tpu_torch.pipelines import STAGE_NAMES, RLInference
from swinwnet_tpu_torch.train import AdamW, RLTrainer, masked_adamw, rl_step

torch.set_num_threads(1)

RL_H, RL_W = 60, 80  # 30x40 tokens at the tiny model; the reward sees 120x160 SR pixels
GRID = np.linspace(0.05, 7.49, 160)
MODEL_LR = 1e-4
RL_TRAINS = ("upscaler_encoder", "upscaler_bottleneck", "upscaler_decoder", "upscaler_head", "ca_seg_to_sr")


def jax_policy_params(shape, seed=1):
    return JaxAlphaPolicy().init(jax.random.PRNGKey(seed), jnp.zeros(shape))


def port_policy(policy_params):
    policy = AlphaPolicy(device="cpu")
    policy.load_state_dict(state_dict_from_jax(policy_params), strict=True)
    return policy


def bragg_images(batch=2):
    """Synthesized patterns with eight Bragg lines each, broadened so that
    their rebinned peaks pass the width gate on the 160-bin grid."""
    lines = [1.0, 1.4, 1.9, 2.5, 3.1, 3.8, 4.4, 5.2]
    return np.stack([
        synthesize_pattern([d + 0.05 * i for d in lines], [1.0] * len(lines), H=RL_H, W=RL_W, seed=i,
                           resolution=0.05, pulse_width=0.1)[None]
        for i in range(batch)
    ]).astype(np.float32)


def test_policy_and_action_match_jax():
    x = np.random.default_rng(0).standard_normal((3, 2, 25, 30)).astype(np.float32)
    pp = jax_policy_params((1, 2, 25, 30))
    mu, std = JaxAlphaPolicy().apply(pp, x)
    policy = port_policy(pp)
    assert set(policy.state_dict()) == {"conv.weight", "conv.bias", "fc.weight", "fc.bias"}
    got_mu, got_std = policy(torch.from_numpy(x))
    h.assert_close(got_mu, mu, tol=1e-5, name="mu")
    np.testing.assert_array_equal(got_std.detach().numpy(), np.asarray(std))
    sr = np.random.default_rng(1).standard_normal((3, 2, 8, 6)).astype(np.float32)
    h.assert_close(apply_action(torch.from_numpy(sr), got_mu.detach()), jax_apply_action(sr, mu), tol=1e-5,
                   name="apply_action")


@pytest.fixture(scope="module")
def rl_serving():
    jmodel, params, port = h.models(seed=2)
    x = h.images(seed=2)
    pp = jax_policy_params((1, 2, h.H, h.W), seed=3)
    want = jax.device_get(make_rl_inference_fn(jmodel, JaxAlphaPolicy())(params, pp, x))
    infer = RLInference(port, port_policy(pp))
    sb.reset_counts()
    out = infer(x)
    return want, infer, out, sb.fused_swin_block_cst.plain_calls


@pytest.mark.parametrize("stage", STAGE_NAMES + ("alpha",))
def test_rl_stage_matches_jax(rl_serving, stage):
    want, infer, _, _ = rl_serving
    got = getattr(infer, stage)
    assert got.device.type == "cpu"
    late = stage in ("upscaled_norm", "upscaled_denorm", "seg_map_hr", "images_masked_hr")
    h.assert_close(got, want[stage], tol=5e-4 if late else 2e-4, name=stage)


def test_rl_inference_returns_last_stage_and_routes_levels(rl_serving):
    """As the 8-stage pipeline: the L0 and SR levels through the kernel
    wrapper, 2 + 6 + 2 blocks (its plain version on the CPU)."""
    _, infer, out, plain_calls = rl_serving
    assert out is infer.images_masked_hr
    assert out.shape == (h.BATCH, 2, 2 * h.H, 2 * h.W) and infer.alpha.shape == (h.BATCH, 1)
    assert plain_calls == 10


@pytest.fixture(scope="module")
def rl_steps():
    """One JAX RL step and one port RL step from the same state."""
    mp = pytest.MonkeyPatch()
    mp.setattr(BasicLayer, "min_windows", 1)
    try:
        params = h.jax_params(seed=2, cfg=h.TINY)["params"]
        images = bragg_images()
        pp = jax_policy_params((1, 2, RL_H // 2, RL_W // 2))
        jmodel, jpolicy = JaxSwinWNet(**h.TINY), JaxAlphaPolicy()
        model_tx, policy_tx = jax_masked_adamw(params, "rl", MODEL_LR, weight_decay=0.0), optax.adam(1e-4)
        step = make_rl_train_step(jmodel, jpolicy, model_tx, policy_tx, JaxQwrapper(fixed_centers=GRID))
        rng = jax.random.PRNGKey(0)
        state = RLState(TrainState.create(params, model_tx), TrainState.create(pp["params"], policy_tx), rng)
        new_state, jm = step(state, images)
        noise = np.asarray(jax.random.normal(jax.random.split(rng)[1], (len(images), 1)))  # the step's draw
        mu = new_state.model.opt_state.inner_states["train"].inner_state[0].mu
        jax_grads = {k: 10.0 * v for k, v in h.flat(mu).items() if v.shape != ()}
        jax_pgrads = {k: 10.0 * v for k, v in h.flat(new_state.policy.opt_state[0].mu).items()}

        port = h.tiny_port(params).train()
        policy = port_policy(pp)
        model_opt = masked_adamw(port, "rl", MODEL_LR, weight_decay=0.0)
        policy_opt = AdamW(policy.parameters(), 1e-4, weight_decay=0.0)
        before = {k: v.clone() for k, v in port.state_dict().items()}
        sb.reset_counts()
        pm = rl_step(port, policy, model_opt, policy_opt, Qwrapper(fixed_centers=GRID, device="cpu"),
                     torch.from_numpy(images), torch.from_numpy(noise))
        calls = [k.plain_calls for k in sb.KERNELS]
        yield dict(params=params, jm=jm, new_state=new_state, jax_grads=jax_grads, jax_pgrads=jax_pgrads,
                   port=port, policy=policy, policy_opt=policy_opt, pm=pm, before=before, calls=calls)
    finally:
        mp.undo()


def test_rl_reward_is_not_zero(rl_steps):
    jm = rl_steps["jm"]
    assert float(jm["reward"]) < 0 and float(jm["integral"]) > 0


@pytest.mark.parametrize("key", ["reward", "policy_loss", "rec", "sup_loss", "integral", "peak", "shape",
                                 "alpha_mean", "alpha_std"])
def test_rl_step_metrics_match_jax(rl_steps, key):
    th.assert_loss(rl_steps["pm"][key], rl_steps["jm"][key], name=key)


def test_rl_step_model_gradients_match_jax(rl_steps):
    r = rl_steps
    th.compare_first_step(r["port"], r["params"], h.flat(r["new_state"].model.params), r["jax_grads"], RL_TRAINS)
    after = r["port"].state_dict()
    for k, v in r["before"].items():
        if not k.startswith(RL_TRAINS):
            assert torch.equal(after[k], v), k  # the segmentator (and the rest) unchanged


def test_rl_step_policy_gradients_and_step_match_jax(rl_steps):
    r = rl_steps
    got = h.flat(jax_tree_from_state_dict({k: p.grad for k, p in r["policy"].named_parameters()}))
    assert set(got) == set(r["jax_pgrads"])
    for k, want in r["jax_pgrads"].items():
        scale = np.abs(want).max()
        assert scale > 0, k  # the reward is not 0, so the policy gradient is not either
        assert np.abs(got[k] - want).max() <= th.GRAD_TOL * scale, k
    got_after = h.flat(jax_tree_from_state_dict(dict(r["policy"].named_parameters())))
    for k, want in h.flat(r["new_state"].policy.params).items():
        np.testing.assert_allclose(got_after[k], want, rtol=0, atol=1e-6, err_msg=k)
    assert r["policy_opt"].count == int(r["new_state"].policy.step) == 1


def test_rl_step_runs_the_fused_wrappers(rl_steps):
    """With the window rule lowered and fused_deep, each of the three tower
    passes (the segment_1 preprocess, the rollout, the update's forward)
    sends (5, 4) blocks to (cmajor, rowmajor), as in
    tests/test_torch_port_trainers.py; the SR head's levels (head widths 2
    and 1) stay unfused."""
    assert rl_steps["calls"] == [15, 12, 0]


def test_adamw_without_decay_is_optax_adam():
    """The policy's optimizer: the port's AdamW with weight_decay 0 takes the
    steps of optax.adam."""
    rng = np.random.default_rng(0)
    p0 = rng.standard_normal((4, 3)).astype(np.float32)
    p = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = AdamW([p], 1e-2, weight_decay=0.0)
    tx = optax.adam(1e-2)
    jp, state = jnp.asarray(p0), tx.init(jnp.asarray(p0))
    for _ in range(5):
        g = rng.standard_normal((4, 3)).astype(np.float32)
        p.grad = torch.from_numpy(g)
        opt.step()
        upd, state = tx.update(jnp.asarray(g), state, jp)
        jp = optax.apply_updates(jp, upd)
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp), rtol=0, atol=1e-7)


def test_rl_trainer_epoch():
    """One epoch of two batches: the metric keys of the JAX trainer, finite,
    the policy and the model stepped twice, the noise drawn from the
    trainer's seeded generator (the same seed gives the same epoch)."""
    histories = []
    for _ in range(2):
        model = h.tiny_port(h.jax_params(seed=2, cfg=h.TINY)["params"])
        policy = port_policy(jax_policy_params((1, 2, RL_H // 2, RL_W // 2)))
        images = bragg_images()
        trainer = RLTrainer(model, policy, [(images,), images], d_centers=GRID, num_epochs=1, model_lr=MODEL_LR,
                            seed=3, verbose=False)
        histories.append(trainer.fit())
        assert trainer.policy_opt.count == trainer.model_opt.count == 2
    (m,), (m2,) = histories
    assert set(m) == {"reward", "rec", "integral", "peak", "shape", "alpha_mean", "alpha_std", "policy_loss",
                      "sup_loss"}
    assert all(np.isfinite(v) for v in m.values()) and m["reward"] < 0
    assert m == m2
