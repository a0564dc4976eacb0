"""The small parts under the port's trainers against the JAX package on
the same numpy inputs: resize and normalization ops and the n-major window
layout (1e-6), every loss and registry string with values and gradients
(1e-5 relative), the warmup-cosine schedule at every step of a 3-epoch run,
and AdamW with stage freezing against `masked_adamw` over 5 steps (1e-6
relative; frozen leaves untouched bit for bit).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from swinwnet_tpu.ops import norms as jnorms
from swinwnet_tpu.ops import resize as jresize
from swinwnet_tpu.ops import window as jwindow
from swinwnet_tpu.train import losses as jlosses
from swinwnet_tpu.train.freeze import masked_adamw as jax_masked_adamw
from swinwnet_tpu.train.schedule import warmup_cosine_schedule as jax_schedule
from swinwnet_tpu_torch.compat import jax_tree_from_state_dict, state_dict_from_jax
from swinwnet_tpu_torch.ops import norms, resize, window
from swinwnet_tpu_torch.train import freeze, losses
from swinwnet_tpu_torch.train.schedule import warmup_cosine_schedule

torch.set_num_threads(1)


def close(got, want, tol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * max(np.abs(want).max(), 1e-6))


# ---- ops ----


@pytest.mark.parametrize("shape", [(2, 2, 10, 12), (1, 2, 11, 13)])
def test_bilinear_downscale_half(shape):
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    close(resize.bilinear_downscale_half(torch.from_numpy(x)), jresize.bilinear_downscale_half(jnp.asarray(x)), 1e-6)


@pytest.mark.parametrize("out", [(20, 24), (15, 7)])
def test_nearest_exact_resize(out):
    x = np.random.default_rng(1).standard_normal((2, 1, 10, 12)).astype(np.float32)
    got = resize.nearest_exact_resize(torch.from_numpy(x), *out)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jresize.nearest_exact_resize(jnp.asarray(x), *out)))


def test_notebook_norms():
    x = np.random.default_rng(2).uniform(0, 1e3, (3, 2, 8, 9)).astype(np.float32)
    got, gp = norms.normalize_piecewise_notebook(torch.from_numpy(x))
    want, wp = jnorms.normalize_piecewise_notebook(jnp.asarray(x))
    close(got, want, 1e-6)
    close(norms.denormalize_piecewise_notebook(got, gp), jnorms.denormalize_piecewise_notebook(want, wp), 1e-6)
    # the pair is deliberately not inverse: the maximum comes back as e - 1 times itself
    assert float(norms.denormalize_piecewise_notebook(got, gp).max()) > 1.5 * x.max()


@pytest.mark.parametrize("grid", [(10, 15), (8, 13)])
def test_window_partition_nmajor_and_reverse(grid):
    x = np.random.default_rng(3).standard_normal((2, *grid, 6)).astype(np.float32)
    got, (Hp, Wp) = window.window_partition_nmajor(torch.from_numpy(x), 5)
    want, (jHp, jWp) = jwindow.window_partition_nmajor(jnp.asarray(x), 5)
    assert (Hp, Wp) == (jHp, jWp)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    back = window.window_reverse_nmajor(got, 5, Hp, Wp)
    np.testing.assert_array_equal(back.numpy(), np.asarray(jwindow.window_reverse_nmajor(want, 5, Hp, Wp)))
    np.testing.assert_array_equal(back[:, :grid[0], :grid[1]].numpy(), x)


# ---- losses ----

SEG_LOSSES = ["CombinedLoss", "DiceLoss", "TverskyLoss", "FocalTverskyLoss", "FocalBCE"]
SR_LOSSES = ["MSELoss", "L1Loss", "SmoothL1Loss", "SSIMLoss", "SmoothL1SSIMLoss"]


def value_and_grad_match(port_fn, jax_fn, pred, target):
    t = torch.from_numpy(pred).requires_grad_(True)
    loss = port_fn(t, torch.from_numpy(target))
    loss.backward()
    want, wgrad = jax.value_and_grad(jax_fn)(jnp.asarray(pred), jnp.asarray(target))
    assert abs(float(loss.detach()) - float(want)) <= 1e-5 * abs(float(want))
    close(t.grad, wgrad, 1e-5)


@pytest.mark.parametrize("name", SEG_LOSSES)
def test_segmentation_loss_registry(name):
    rng = np.random.default_rng(len(name))
    logits = (3 * rng.standard_normal((3, 1, 12, 14))).astype(np.float32)
    target = (rng.uniform(size=(3, 1, 12, 14)) > 0.7).astype(np.float32)
    value_and_grad_match(losses.get_segmentation_loss(name), jlosses.get_segmentation_loss(name), logits, target)


@pytest.mark.parametrize("name", SR_LOSSES)
def test_upscaler_loss_registry(name):
    rng = np.random.default_rng(len(name))
    pred = rng.uniform(-0.2, 1.6, (2, 2, 16, 18)).astype(np.float32)  # both SmoothL1 branches, both clamps
    target = rng.uniform(0, 1, (2, 2, 16, 18)).astype(np.float32)
    value_and_grad_match(losses.get_upscaler_loss(name), jlosses.get_upscaler_loss(name), pred, target)


@pytest.mark.parametrize("name", ["bce_with_logits", "combined_loss_weighted", "focal_bce_sum"])
def test_loss_options(name):
    rng = np.random.default_rng(9)
    logits = (3 * rng.standard_normal((2, 1, 8, 9))).astype(np.float32)
    target = (rng.uniform(size=(2, 1, 8, 9)) > 0.5).astype(np.float32)
    wmap = rng.uniform(0.5, 2.0, (2, 1, 8, 9)).astype(np.float32)
    port_fn, jax_fn = {
        "bce_with_logits": (lambda a, b: losses.bce_with_logits(a, b, "sum"), lambda a, b: jlosses.bce_with_logits(a, b, "sum")),
        "combined_loss_weighted": (
            lambda a, b: losses.combined_loss(a, b, torch.from_numpy(wmap), 0.5, 2.0),
            lambda a, b: jlosses.combined_loss(a, b, jnp.asarray(wmap), 0.5, 2.0)),
        "focal_bce_sum": (lambda a, b: losses.focal_bce(a, b, reduction="sum"), lambda a, b: jlosses.focal_bce(a, b, reduction="sum")),
    }[name]
    value_and_grad_match(port_fn, jax_fn, logits, target)


def test_unknown_loss_names_raise():
    with pytest.raises(KeyError, match="segmentation"):
        losses.get_segmentation_loss("SmoothL1Loss")
    with pytest.raises(KeyError, match="upscaler"):
        losses.get_upscaler_loss("DiceLoss")


# ---- schedule ----


@pytest.mark.parametrize("warmup,epochs,spe", [(1, 3, 4), (2, 3, 5), (0, 3, 2)])
def test_schedule_at_every_step(warmup, epochs, spe):
    port, ref = warmup_cosine_schedule(2e-4, warmup, epochs, spe), jax_schedule(2e-4, warmup, epochs, spe)
    for step in range(epochs * spe + 1):
        assert abs(port(step) - float(ref(step))) <= 1e-6 * 2e-4, step
    assert port(0) == port(spe - 1)  # held within the epoch


# ---- AdamW with stage freezing ----

TOP_LEVEL = ("patch_embed", "segmentator_encoder", "segmentator_head", "ca_seg_to_sr", "ca_sr_to_seg",
             "upscaler_encoder", "upscaler_head")


class Towers(torch.nn.Module):
    """One small Linear under each top-level name of SwinWNet: the stage
    vocabularies see the names, AdamW the tensors."""

    def __init__(self):
        super().__init__()
        for name in TOP_LEVEL:
            setattr(self, name, torch.nn.Linear(5, 7))


def tiny_jax_params(seed):
    rng = np.random.default_rng(seed)
    draw = lambda *s: (0.1 * rng.standard_normal(s)).astype(np.float32)
    return {name: {"kernel": draw(5, 7), "bias": draw(7)} for name in TOP_LEVEL}


@pytest.mark.parametrize("stage", ["stage1", "stage2", "stage3", "rl", "all"])
def test_adamw_matches_masked_adamw(stage):
    params = tiny_jax_params(0)
    port = Towers()
    port.load_state_dict(state_dict_from_jax(params), strict=True)
    before = {k: v.detach().clone() for k, v in port.named_parameters()}
    sched = lambda spe: dict(base_lr=1e-2, warmup_epochs=1, num_epochs=3, steps_per_epoch=spe)
    tx = jax_masked_adamw(params, stage, jax_schedule(**sched(2)), weight_decay=1e-2)
    opt = freeze.masked_adamw(port, stage, warmup_cosine_schedule(**sched(2)), weight_decay=1e-2)
    opt_state = tx.init(params)
    for step in range(5):
        grads = tiny_jax_params(100 + step)  # the same synthetic gradients for both
        tgrads = state_dict_from_jax(grads)
        for name, p in port.named_parameters():
            p.grad = tgrads[name].clone() if p.requires_grad else None
        opt.step()
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
    assert opt.count == 5
    got = jax_tree_from_state_dict(dict(port.named_parameters()))
    flat_want = jax.tree_util.tree_flatten_with_path(params)[0]
    flat_got = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    assert len(flat_want) == len(flat_got)
    for path, want in flat_want:
        np.testing.assert_allclose(flat_got[path], np.asarray(want), rtol=1e-6, atol=1e-7, err_msg=str(path))
    trainable = set(freeze.stage_trainable_names(port, stage))
    for name, p in port.named_parameters():
        assert p.requires_grad == (name in trainable)
        assert torch.equal(p.detach(), before[name]) == (name not in trainable), name
