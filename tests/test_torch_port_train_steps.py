"""`TrainState` and the step factories of the port
(swinwnet_tpu_torch/train/trainers.py: `make_stage1_step`, `make_stage1_eval`,
`make_stage2_step`, `make_stage2_eval`, `make_stage3_steps`) against the JAX
package's, and the optimizer whose count lives on the device
(train/freeze.py `AdamW`) against optax.

Each factory takes three steps from the same weights on the same batches
with a `warmup_cosine_schedule` of two steps an epoch and two warm-up
epochs, so the epoch, and with it the learning rate, changes at the third
step; then its eval runs on a fourth batch. The JAX model runs its fused
blocks in interpret mode, the port its wrappers' plain versions (see
tests/_torch_port_train_helpers.py). Limits: each loss 1e-4 relative, each
leaf after the steps within 1e-3 of its max|JAX| (the trainer-parity
limits; both differentiate the same fp32 math in other summation orders).
Observed: losses within 7.5e-6, evals 2.4e-5, leaves 8.6e-4 of their max at
worst (stage 3 even, a bottleneck fc2 kernel: Adam moves a component whose
gradient is near 0 by about the rate whatever its size, so the leaves'
limit holds the schedule and the update, while the losses hold the
gradients). AdamW against `optax.adamw` over five scheduled steps with the
same gradients: 1e-6 relative, the check of the device count and the
schedule it reads.

The cases marked `cuda` capture the steps on the card (`python -m pytest
--noconftest tests/test_torch_port_train_steps.py -m cuda`); JAX is
imported inside the tests that use it."""

import contextlib

import numpy as np
import pytest
import torch

from swinwnet_tpu_torch.core import graphs
from swinwnet_tpu_torch.models import BasicLayer, SwinWNet
from swinwnet_tpu_torch.train import (
    AdamW,
    SegmentatorTrainer,
    TrainState,
    combined_loss,
    make_stage1_eval,
    make_stage1_step,
    make_stage2_eval,
    make_stage2_step,
    make_stage3_steps,
    masked_adamw,
    smooth_l1_loss,
    warmup_cosine_schedule,
)

torch.set_num_threads(1)

# the trainers' default rate: at 1e-3 two Adam steps of the tiny model amplify
# the summation-order noise of its near-zero gradient components (Adam
# scales each component to about the rate) to 5.7e-4 of stage 2's third loss
SCHED = dict(base_lr=2e-4, warmup_epochs=2, num_epochs=4, steps_per_epoch=2)
WD = 1e-2
STEPS = 3
WEIGHTS = (1.0, 0.7, 1.3)
LOSS_RTOL, LEAF_TOL = 1e-4, 1e-3
KINDS = ("stage1", "stage2", "stage3_even", "stage3_odd")


def jax_factories(kind, jmodel, tx):
    from swinwnet_tpu.train.losses import combined_loss as jcombined, smooth_l1_loss as jsmooth
    from swinwnet_tpu.train.trainers import (
        make_stage1_eval as j1e, make_stage1_step as j1, make_stage2_eval as j2e, make_stage2_step as j2,
        make_stage3_steps as j3)

    if kind == "stage1":
        return j1(jmodel, tx, jcombined), j1e(jmodel, jcombined)
    if kind == "stage2":
        return j2(jmodel, tx, jsmooth), j2e(jmodel, jsmooth)
    even, odd, even_eval, odd_eval = j3(jmodel, tx, jcombined, jsmooth, *WEIGHTS)
    return (even, even_eval) if kind == "stage3_even" else (odd, odd_eval)


def port_factories(kind, model, tx):
    if kind == "stage1":
        return make_stage1_step(model, tx, combined_loss), make_stage1_eval(model, combined_loss)
    if kind == "stage2":
        return make_stage2_step(model, tx, smooth_l1_loss), make_stage2_eval(model, smooth_l1_loss)
    even, odd, even_eval, odd_eval = make_stage3_steps(model, tx, combined_loss, smooth_l1_loss, *WEIGHTS)
    return (even, even_eval) if kind == "stage3_even" else (odd, odd_eval)


def loss_of(out):
    return out["loss"] if isinstance(out, dict) else out


@pytest.fixture(scope="module")
def runs():
    """Each kind's three steps and eval on both sides."""
    import _torch_port_helpers as h
    from swinwnet_tpu.models import SwinWNet as JaxSwinWNet
    from swinwnet_tpu.train.freeze import masked_adamw as jax_masked_adamw
    from swinwnet_tpu.train.schedule import warmup_cosine_schedule as jax_schedule
    from swinwnet_tpu.train.trainers import TrainState as JaxTrainState
    from swinwnet_tpu_torch.compat import jax_tree_from_state_dict

    mp = pytest.MonkeyPatch()
    mp.setenv("SWINWNET_FUSED_INTERPRET", "1")
    mp.setenv("SWINWNET_FUSED_DEEP", "1")
    mp.setattr(BasicLayer, "min_windows", 1)
    out = {}
    try:
        params = h.jax_params(seed=11, cfg=h.TINY)["params"]
        batches = h.training_batches(STEPS + 1, seed=11)
        jmodel = JaxSwinWNet(**h.TINY, use_pallas=True)
        for kind in KINDS:
            stage = kind if kind in ("stage1", "stage2") else "stage3"
            tx = jax_masked_adamw(params, stage, jax_schedule(**SCHED), WD)
            jstate = JaxTrainState.create(params, tx)
            jstep, jeval = jax_factories(kind, jmodel, tx)
            jlosses = []
            for images, masks in batches[:STEPS]:
                jstate, jout = jstep(jstate, images, masks)
                jlosses.append(float(loss_of(jout)))
            jeval_loss = float(loss_of(jeval(jstate.params, *batches[STEPS])))

            port = h.tiny_port(params).train()
            ptx = masked_adamw(port, stage, warmup_cosine_schedule(**SCHED), WD)
            state = TrainState.create(port, ptx)
            step, eval_step = port_factories(kind, port, ptx)
            losses, same_state = [], True
            for images, masks in batches[:STEPS]:
                new_state, pout = step(state, images, masks)
                same_state &= new_state is state
                losses.append(float(loss_of(pout)))
            out[kind] = dict(jlosses=jlosses, jeval=jeval_loss, jparams=h.flat(jstate.params), losses=losses,
                             eval=float(loss_of(eval_step(*batches[STEPS]))), same_state=same_state, state=state,
                             params=h.flat(jax_tree_from_state_dict(dict(port.named_parameters()))))
        yield out
    finally:
        mp.undo()


@pytest.mark.parametrize("kind", KINDS)
def test_step_losses_match_jax(runs, kind):
    r = runs[kind]
    for i, (got, want) in enumerate(zip(r["losses"], r["jlosses"])):
        assert np.isfinite(got) and abs(got - want) <= LOSS_RTOL * abs(want), f"step {i}: {got} vs {want}"


@pytest.mark.parametrize("kind", KINDS)
def test_eval_matches_jax(runs, kind):
    r = runs[kind]
    assert abs(r["eval"] - r["jeval"]) <= LOSS_RTOL * abs(r["jeval"])


def key_thirds(name, leaf):
    """The key bias of an attention's fused qkv bias (the middle third): a
    shift shared by a row's scores, which the softmax ignores, so its
    gradient is 0 in exact arithmetic and summation noise in either
    framework; Adam scales that noise to about the rate."""
    if name.endswith("qkv/bias") or name.endswith("in_proj_bias"):
        c = leaf.shape[-1] // 3
        return slice(c, 2 * c)
    return slice(0, 0)


@pytest.mark.parametrize("kind", KINDS)
def test_leaves_after_the_steps_match_jax(runs, kind):
    """Each leaf within LEAF_TOL of its max; a key bias, whose gradient is
    noise, within the most Adam can move it in either run: the rate plus
    the decay's share, summed over the steps."""
    r = runs[kind]
    assert r["params"].keys() == r["jparams"].keys()
    sched = warmup_cosine_schedule(**SCHED)
    travel = sum(sched(i) * (1.0 + WD) for i in range(STEPS))
    for k, want in r["jparams"].items():
        diff = np.abs(r["params"][k] - want)
        noise = key_thirds(k, want)
        assert diff[..., noise].max(initial=0.0) <= 2 * travel, k
        diff[..., noise] = 0.0
        assert diff.max() <= LEAF_TOL * max(np.abs(want).max(), 1e-6), f"{k}: {diff.max():.3e}"


@pytest.mark.parametrize("kind", KINDS)
def test_state_is_updated_in_place_and_counts_steps(runs, kind):
    r = runs[kind]
    state = r["state"]
    assert r["same_state"] and state.step is state.opt_state.count
    assert state.step.dtype == torch.int64 and int(state.step) == STEPS
    trains = {"stage1": "patch_embed", "stage2": "upscaler_encoder"}.get(kind, "ca_seg_to_sr")
    assert any(name.startswith(trains) for name in state.params)


def test_adamw_with_a_device_count_matches_optax():
    """Every parameter trained, a scheduled rate, five steps: the count, the
    rate and the bias corrections are read on the parameters' device."""
    import jax
    import jax.numpy as jnp
    import optax
    from swinwnet_tpu.train.schedule import warmup_cosine_schedule as jax_schedule

    rng = np.random.default_rng(0)
    shapes = [(5, 7), (7,), (3, 2, 2)]
    p0 = [(0.1 * rng.standard_normal(s)).astype(np.float32) for s in shapes]
    params = [torch.nn.Parameter(torch.from_numpy(a.copy())) for a in p0]
    opt = AdamW(params, warmup_cosine_schedule(**SCHED), weight_decay=WD)
    tx = optax.adamw(jax_schedule(**SCHED), weight_decay=WD)
    jparams = [jnp.asarray(a) for a in p0]
    jstate = tx.init(jparams)
    for i in range(5):
        grads = [(0.1 * rng.standard_normal(s)).astype(np.float32) for s in shapes]
        for p, g in zip(params, grads):
            p.grad = torch.from_numpy(g.copy())
        assert isinstance(opt.lr(), torch.Tensor) and opt.lr().dtype == torch.float32
        opt.step()
        updates, jstate = tx.update([jnp.asarray(g) for g in grads], jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
    assert opt.count.dtype == torch.int64 and int(opt.count) == 5
    for p, want in zip(params, jax.device_get(jparams)):
        np.testing.assert_allclose(p.detach().numpy(), want, rtol=1e-6, atol=1e-7)


def test_zero_grad_keeps_the_gradient_tensors():
    p = torch.nn.Parameter(torch.ones(3))
    opt = AdamW([p], 1e-3)
    p.grad = torch.full((3,), 2.0)
    g = p.grad
    opt.zero_grad()
    assert p.grad is g and torch.equal(g, torch.zeros(3))


def test_an_int_count_state_loads_in_place():
    """Checkpoints keep `count` as an int (every one written so far): it
    loads into the device count in place, and `state_dict` writes an int."""
    p = torch.nn.Parameter(torch.ones(3))
    opt = AdamW([p], warmup_cosine_schedule(**SCHED))
    count = opt.count
    opt.load_state_dict({"count": 3, "m": [torch.full((3,), 0.5)], "v": [torch.full((3,), 0.25)]})
    assert opt.count is count and int(count) == 3 and torch.equal(opt.m[0], torch.full((3,), 0.5))
    assert opt.state_dict()["count"] == 3 and isinstance(opt.state_dict()["count"], int)
    assert float(opt.lr()) == pytest.approx(warmup_cosine_schedule(**SCHED)(3))


def test_the_schedule_on_a_tensor_matches_the_int_form_and_jax():
    """In fp32 as optax evaluates the JAX schedule: within 4 fp32 ulps of
    the base rate of the float64 int form and of the JAX schedule (the
    cosine's tail, 0.5 * (1 + cos) near cos = -1, cancels digits)."""
    import jax.numpy as jnp
    from swinwnet_tpu.train.schedule import warmup_cosine_schedule as jax_schedule

    args = (2e-4, 3, 10, 4)
    sched, jsched = warmup_cosine_schedule(*args), jax_schedule(*args)
    for step in range(0, 48, 3):
        got = sched(torch.tensor(step))
        assert got.dtype == torch.float32
        for want in (sched(step), float(jsched(jnp.int32(step)))):
            assert abs(float(got) - want) <= 2.0 ** -21 * args[0], (step, float(got), want)


def test_trainer_save_and_resume_through_the_state(tmp_path):
    import _torch_port_helpers as h

    batches = h.training_batches(2, seed=3)
    model = SwinWNet(**h.TINY, device="cpu", generator=torch.Generator().manual_seed(3))
    trainer = SegmentatorTrainer(model, batches, num_epochs=1, warmup_epochs=1, verbose=False)
    trainer.train_step(*batches[0])
    trainer.save(str(tmp_path))
    other = SegmentatorTrainer(SwinWNet(**h.TINY, device="cpu"), batches, num_epochs=1, warmup_epochs=1,
                               verbose=False)
    assert other.resume(str(tmp_path)) and other.step == 1
    assert torch.equal(other.optimizer.m[0], trainer.optimizer.m[0])
    a, b = trainer.train_step(*batches[1]), other.train_step(*batches[1])
    assert torch.equal(a, b) and trainer.step == other.step == 2
    trainer.release_training_state()
    assert trainer.optimizer is None and trainer.step == 2


# ---- on the card ----


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("kind", KINDS)
def test_captured_steps_match_eager_steps(cuda, kind):
    """Four captured steps against four eager ones from the same weights
    and batches, the rate doubling between steps 2 and 3: the same bits."""
    cfg = dict(patch_size=2, in_chans=1, error_matrix=True, embed_dim=12, depths=(1, 1, 1, 1),
               num_heads=(3, 3, 3, 3), window_size=5)
    rng = np.random.default_rng(1)
    batches = [(torch.from_numpy(rng.uniform(0, 1e3, (2, 2, 20, 30)).astype(np.float32)).to(cuda),
                torch.from_numpy((rng.uniform(size=(2, 20, 30)) > 0.6).astype(np.float32)).to(cuda))
               for _ in range(4)]
    runs = []
    for eager in (True, False):
        model = SwinWNet(**cfg, fused_blocks=True, device="cuda", generator=torch.Generator().manual_seed(5)).train()
        tx = masked_adamw(model, kind if kind in ("stage1", "stage2") else "stage3", warmup_cosine_schedule(**SCHED))
        state = TrainState.create(model, tx)
        step, _ = port_factories(kind, model, tx)
        losses = []
        with graphs.run_eagerly() if eager else contextlib.nullcontext():
            for images, masks in batches:
                state, out = step(state, images, masks)
                losses.append(float(loss_of(out)))
        runs.append((losses, {k: p.detach().clone() for k, p in model.named_parameters()}))
    assert runs[0][0] == runs[1][0]
    assert all(torch.equal(runs[0][1][k], runs[1][1][k]) for k in runs[0][1])
