"""`swinwnet_tpu_torch.parallel` on the CPU over gloo, against the JAX
package's `parallel` and its unsharded stage-3 odd step.

* `pad_to_multiple` and `process_batch_slice` equal JAX's; the
  single-process no-op; the init refuses what it cannot do.
* A one-process gloo group in a subprocess (a free port: xdist runs files
  side by side) shards arange(8) and all-reduces it to 28, as
  tests/test_multihost.py does with jax.distributed.
* `dryrun_multichip(2, device="cpu")` on the tiny model: each rank's
  slice through stage3_odd_loss, the all-reduced gradients and the AdamW
  update against the same step in one process on the full batch. Loss
  rtol 1e-5 (measured 1e-7); averaged gradients within 1e-3 of each leaf's
  largest (the trainer tests' GRAD_TOL; measured 1.6e-4: two summation
  orders of leaves whose terms nearly cancel); updated parameters rtol 1e-5,
  atol 1e-6 (tests/test_sharding.py:66-113) on every element whose
  gradient is at least 1e-7. Below that, ten times AdamW's eps, the first
  step g / (|g| + eps) divides a gradient by itself plus eps, and the two
  summation orders move such elements by up to 1.2e-5 (measured: about
  200 of the 1.25M elements, all with |g| < 5e-8): those are held within
  2 * lr, the most a first step moves them, and fewer than 1e-3 of the
  elements may be among them. The HR IoU is
  the batch's, from all-reduced sums.
* The same step against the JAX package's unsharded make_stage3_steps odd
  step from the same weights: loss 1e-4, gradients 1e-3 of each leaf's
  largest (2e-2 for the one-element gammas), as the trainer tests."""

import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import _torch_port_helpers as h
import _torch_port_train_helpers as th
from swinwnet_tpu.parallel import pad_to_multiple as jax_pad_to_multiple
from swinwnet_tpu.parallel.multihost import process_batch_slice as jax_process_batch_slice
from swinwnet_tpu_torch.compat import jax_tree_from_state_dict
from swinwnet_tpu_torch.models import SwinWNet
from swinwnet_tpu_torch.ops.norms import ensure_2ch
from swinwnet_tpu_torch.parallel import (
    dryrun_multichip,
    initialize_multihost,
    make_mesh,
    pad_to_multiple,
    process_batch_slice,
)
from swinwnet_tpu_torch.parallel.dryrun import LR, WEIGHTS, dryrun_batch, free_port
from swinwnet_tpu_torch.train import combined_loss, masked_adamw, smooth_l1_loss
from swinwnet_tpu_torch.train.trainers import stage3_odd_loss

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
HW = (h.TINY_H, h.TINY_W)
SEED = 1  # weights whose HR prediction is not all below 0.5, so that iou_hr is not 0
ADAM_EPS = 1e-8


@pytest.mark.parametrize("shape,multiple", [((5, 3), 8), ((8, 3), 8), ((3, 2, 4), 2), ((7,), 4)])
def test_pad_to_multiple_matches_jax(shape, multiple):
    x = np.arange(int(np.prod(shape)), dtype=np.float32).reshape(shape)
    got, n = pad_to_multiple(x, multiple)
    want, n_want = jax_pad_to_multiple(x, multiple)
    assert n == n_want == shape[0]
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


@pytest.mark.parametrize("batch,n,pid", [(100, 4, 0), (100, 4, 3), (8, 2, 1), (6, 1, 0)])
def test_process_batch_slice_matches_jax(batch, n, pid):
    assert process_batch_slice(batch, n, pid) == jax_process_batch_slice(batch, n, pid)


def test_process_batch_slice_refuses_an_indivisible_batch():
    with pytest.raises(ValueError):
        process_batch_slice(10, num_processes=4, process_id=0)
    assert process_batch_slice(10) == slice(0, 10)  # no group: one process


def test_single_process_is_a_noop_and_the_init_refuses_what_it_cannot_do(monkeypatch):
    assert initialize_multihost() is False
    assert initialize_multihost(num_processes=1) is False
    with pytest.raises(ValueError, match="process_id"):
        initialize_multihost("localhost:1", num_processes=2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        initialize_multihost("localhost:1", 2, 0)  # the card by default, and no fallback to gloo
    with pytest.raises(RuntimeError, match="initialize_multihost"):
        make_mesh()
    with pytest.raises(RuntimeError, match="CUDA"):
        dryrun_multichip(1)  # the card by default


ONE_PROCESS_GROUP = r"""
import sys, numpy as np, torch, torch.distributed as dist
from swinwnet_tpu_torch.parallel import (allreduce_gradients, data_sharding, initialize_multihost, make_mesh,
                                         process_batch_slice, replicate, shard_batch)
assert initialize_multihost("localhost:" + sys.argv[1], num_processes=1, process_id=0, device="cpu") is True
assert dist.get_backend() == "gloo" and dist.get_world_size() == 1
mesh = make_mesh()
assert mesh.mesh_dim_names == ("data",) and mesh.size() == 1 and mesh.device_type == "cpu"
assert type(data_sharding(mesh)[0]).__name__ == "Shard" and data_sharding(mesh)[0].dim == 0
x, y = shard_batch((np.arange(8.0).reshape(8, 1), torch.ones(8)), mesh)
assert x.shape == (8, 1) and process_batch_slice(8) == slice(0, 8)
total = x.sum()
dist.all_reduce(total, group=mesh.get_group())
assert float(total) == 28.0, total
lin = replicate(torch.nn.Linear(3, 2), mesh)
lin(torch.ones(4, 3)).sum().backward()
g = lin.weight.grad.clone()
allreduce_gradients(lin, mesh)
assert torch.equal(lin.weight.grad, g)
dist.destroy_process_group()
print("GROUP_OK")
"""


def test_one_process_gloo_group():
    res = subprocess.run([sys.executable, "-c", ONE_PROCESS_GROUP, str(free_port())], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert "GROUP_OK" in res.stdout, res.stdout + res.stderr


@pytest.fixture(scope="module")
def steps():
    """The 2-rank dry run, and the same step in this process on the full
    batch: (its output, (model after the step, its gradients, aux), the
    weights before)."""
    sharded = dryrun_multichip(2, device="cpu", hw=HW, model_kw=h.TINY, seed=SEED)
    model = SwinWNet(**h.TINY, device="cpu", generator=torch.Generator().manual_seed(SEED))
    before = {k: p.detach().clone() for k, p in model.named_parameters()}
    images, masks = dryrun_batch(2, HW)
    opt = masked_adamw(model, "stage3", LR)
    total, aux = stage3_odd_loss(model, combined_loss, smooth_l1_loss, WEIGHTS,
                                 ensure_2ch(torch.from_numpy(images)), torch.from_numpy(masks)[:, None])
    opt.zero_grad()
    total.backward()
    opt.step()
    grads = {k: p.grad for k, p in model.named_parameters() if p.grad is not None}
    return sharded, (model, grads, {k: float(v.detach()) for k, v in aux.items()}), before


def test_two_ranks_equal_one_process_on_the_full_batch(steps):
    sharded, (model, grads, aux), before = steps
    assert abs(sharded["loss"] - aux["loss"]) <= 1e-5 * abs(aux["loss"])
    assert sharded["grads"].keys() == grads.keys() and len(grads) > 100
    changed = off = 0
    for k, p in model.named_parameters():
        g, got, want = grads[k], sharded["params"][k], p.detach()
        assert (sharded["grads"][k] - g).abs().max() <= 1e-3 * g.abs().max(), k
        diff = (got - want).abs()
        outside = diff > 1e-6 + 1e-5 * want.abs()
        assert not bool((outside & (g.abs() >= 10 * ADAM_EPS)).any()), k  # rtol 1e-5, atol 1e-6 there
        assert bool((diff <= 2 * LR).all()), k
        off += int(outside.sum())
        changed += not torch.equal(got, before[k])
    assert changed > 100  # the update is not a no-op
    assert off < 1e-3 * sum(p.numel() for p in model.parameters())


def test_iou_hr_is_the_batch_value(steps):
    sharded, (_, _, aux), _ = steps
    assert aux["iou_hr"] > 0.1
    assert abs(sharded["iou_hr"] - aux["iou_hr"]) <= 1e-6
    for k in ("seg_lr", "seg_hr"):
        assert abs(sharded[k] - aux[k]) <= 1e-5 * abs(aux[k]), k


def test_the_sharded_step_matches_the_jax_unsharded_step(steps):
    from swinwnet_tpu.models import SwinWNet as JaxSwinWNet
    from swinwnet_tpu.train.freeze import masked_adamw as jax_masked_adamw
    from swinwnet_tpu.train.losses import combined_loss as jax_combined
    from swinwnet_tpu.train.losses import smooth_l1_loss as jax_smooth_l1
    from swinwnet_tpu.train.trainers import TrainState, make_stage3_steps

    sharded, _, before = steps
    params = jax_tree_from_state_dict(before)
    tx = jax_masked_adamw(params, "stage3", LR)
    _, odd_step, _, _ = make_stage3_steps(JaxSwinWNet(**h.TINY), tx, jax_combined, jax_smooth_l1)
    state, aux = odd_step(TrainState.create(params, tx), *dryrun_batch(2, HW))
    th.assert_loss(sharded["loss"], aux["loss"], "loss")
    mu = h.flat(state.opt_state.inner_states["train"].inner_state[0].mu)
    jax_grads = {k: 10.0 * v for k, v in mu.items()}  # mu_1 = (1 - b1) * g
    port_grads = h.flat(jax_tree_from_state_dict(sharded["grads"]))
    assert port_grads.keys() == jax_grads.keys()
    for k, g in port_grads.items():
        want = jax_grads[k]
        tol = th.GAMMA_TOL if k.endswith("/gamma") else th.GRAD_TOL
        assert np.abs(g - want).max() <= tol * np.abs(want).max(), k
    moved = h.flat(state.params)
    assert all(np.array_equal(moved[k], v) == np.array_equal(sharded_v, before_v)
               for (k, v), sharded_v, before_v in zip(
                   h.flat(params).items(),
                   h.flat(jax_tree_from_state_dict(sharded["params"])).values(),
                   h.flat(jax_tree_from_state_dict(before)).values()))
