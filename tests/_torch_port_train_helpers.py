"""Shared body of the trainer-parity tests (tests/test_torch_port_trainers*.py):
run the same weights and the same two batches through a JAX train step and the
port's, and compare losses, first-step gradients and which parameters moved.

The JAX model runs with `use_pallas=True` and the package's own CPU switches
(SWINWNET_FUSED_INTERPRET=1, SWINWNET_FUSED_DEEP=1), so its forward goes
through the Pallas kernels in interpret mode and its backward through
`fused_block_autodiff`'s recompute; the port runs with `fused_blocks=True,
fused_deep=True` and the 128-window rule lowered, so its forward goes
through the wrappers (plain versions on the CPU) and its backward through
the autograd Function.

The first step's JAX gradient is read back from AdamW's first moment:
mu_1 = (1 - b1) * g, so g = 10 * mu_1 (exact to fp32 rounding), which saves
compiling a second program per stage.
"""

import numpy as np
import torch

import _torch_port_helpers as h
from swinwnet_tpu.train.freeze import masked_adamw as jax_masked_adamw
from swinwnet_tpu.train.trainers import TrainState
from swinwnet_tpu_torch.compat import jax_tree_from_state_dict

LR, WD = 1e-3, 1e-2
LOSS_RTOL = 1e-4
# per leaf, relative to the leaf's largest gradient: both backwards
# differentiate the same fp32 math in other summation orders
GRAD_TOL = 1e-3
# the four cross-attention gammas are one number each: the sum, over every
# token and channel, of products of either sign that nearly cancel. The
# rounding error scales with the sum of the terms' magnitudes, not with the
# result, so a leaf of one element has no larger neighbour to be measured
# against (observed 6e-3 of itself at the tiny geometry)
GAMMA_TOL = 2e-2


def jax_run(stage, make_step, params, batches):
    """[(loss or aux, params after)] per batch, and the first step's gradients
    of the trainable leaves."""
    tx = jax_masked_adamw(params, stage, LR, WD)
    state = TrainState.create(params, tx)
    steps = make_step(tx)
    out, grads = [], None
    for i, (images, masks) in enumerate(batches):
        step = steps[i % len(steps)]
        state, loss = step(state, images, masks)
        if i == 0:
            mu = state.opt_state.inner_states["train"].inner_state[0].mu
            grads = {k: 10.0 * v for k, v in h.flat(mu).items() if v.shape != ()}
        out.append((loss, h.flat(state.params)))
    return out, grads


def compare_first_step(port, jax_params_before, jax_after, jax_grads, trainable):
    """Gradients leaf by leaf, and the set of parameters that moved."""
    port_grads = h.flat(jax_tree_from_state_dict(
        {k: p.grad for k, p in port.named_parameters() if p.grad is not None}))
    before = h.flat(jax_params_before)
    after_port = h.flat(jax_tree_from_state_dict(dict(port.named_parameters())))
    moved_jax = {k for k in before if not np.array_equal(before[k], jax_after[k])}
    moved_port = {k for k in before if not np.array_equal(before[k], after_port[k])}
    assert moved_jax == moved_port
    assert moved_port and all(k.split("/")[0] in trainable or trainable == "all" for k in moved_port)
    checked = 0
    for k, g in port_grads.items():
        want = jax_grads[k]
        scale = np.abs(want).max()
        if scale == 0:
            assert np.abs(g).max() == 0, k
            continue
        err = np.abs(g - want).max()
        tol = GAMMA_TOL if k.endswith("/gamma") else GRAD_TOL
        assert err <= tol * scale, f"{k}: {err:.3e} vs {tol * scale:.3e}"
        checked += 1
    assert checked > 20
    return port_grads


def assert_loss(got, want, name=""):
    got, want = float(got), float(want)
    assert abs(got - want) <= LOSS_RTOL * abs(want), f"{name}: {got} vs {want}"
