"""Stage 3 (even and odd steps) of the port's FullModelTrainer against the
JAX package's jitted steps, in the manner of tests/test_torch_port_trainers.py:
same weights, same two batches (batch 0 through the step under test, then
batch 1 through it again); each loss term of each step (1e-4 relative), the
first step's gradients leaf by leaf (1e-3 * max|g|), which parameters moved.
And the bf16 compute dtype on the port: fp32 parameters, finite losses that
track the fp32 run within 2e-2 relative (the band of
tests/test_mixed_precision.py:54, over 4 steps)."""

import numpy as np
import pytest
import torch

import _torch_port_helpers as h
import _torch_port_train_helpers as th
from swinwnet_tpu.models import SwinWNet as JaxSwinWNet
from swinwnet_tpu.train.losses import combined_loss, smooth_l1_loss
from swinwnet_tpu.train.trainers import make_stage3_steps
from swinwnet_tpu_torch.models import BasicLayer
from swinwnet_tpu_torch.ops import swin_block as sb
from swinwnet_tpu_torch.train import FullModelTrainer, SegmentatorTrainer

torch.set_num_threads(1)

WEIGHTS = dict(seg_weight_lr=1.0, seg_weight_hr=0.7, rec_weight=1.3)


@pytest.fixture(scope="module")
def lowered_window_rule():
    mp = pytest.MonkeyPatch()
    mp.setenv("SWINWNET_FUSED_INTERPRET", "1")
    mp.setenv("SWINWNET_FUSED_DEEP", "1")
    mp.setattr(BasicLayer, "min_windows", 1)
    yield
    mp.undo()


@pytest.fixture(scope="module")
def runs(lowered_window_rule):
    params = h.jax_params(seed=6, cfg=h.TINY)["params"]
    batches = h.training_batches(2, seed=6)
    jmodel = JaxSwinWNet(**h.TINY, use_pallas=True)
    out = {}
    for which, even in (("even", True), ("odd", False)):
        pick = lambda tx, even=even: (make_stage3_steps(
            jmodel, tx, combined_loss, smooth_l1_loss, **WEIGHTS)[0 if even else 1],)
        jout, jgrads = th.jax_run("stage3", pick, params, batches)
        port = h.tiny_port(params).train()
        trainer = FullModelTrainer(port, batches, num_epochs=1, warmup_epochs=1, lr=th.LR,
                                   weight_decay=th.WD, verbose=False, **WEIGHTS)
        sb.reset_counts()
        aux = [trainer.train_step(*batches[0], even=even)]
        calls = [k.plain_calls for k in sb.KERNELS]
        first_error = None  # compared now, while the state is that of step 1
        try:
            th.compare_first_step(port, params, jout[0][1], jgrads, "all")
        except AssertionError as e:  # raised again by the test that reads it
            first_error = e
        aux.append(trainer.train_step(*batches[1], even=even))
        out[which] = dict(jax=jout, aux=aux, first_error=first_error, calls=calls)
    return out


@pytest.mark.parametrize("which", ["even", "odd"])
def test_loss_terms_of_both_steps(runs, which):
    r = runs[which]
    terms = ("loss", "seg_lr", "rec") if which == "even" else ("loss", "seg_lr", "seg_hr", "iou_hr")
    for i, (got, (want, _)) in enumerate(zip(r["aux"], r["jax"])):
        for k in terms:
            assert np.isfinite(float(got[k]))
            if k == "iou_hr":  # a count ratio at the 0.5 threshold
                assert abs(float(got[k]) - float(want[k])) <= 1e-3
            else:
                th.assert_loss(got[k], want[k], f"{which} step {i} {k}")
        assert float(got["seg_hr" if which == "even" else "rec"]) == 0.0


@pytest.mark.parametrize("which", ["even", "odd"])
def test_first_step_gradients_and_moved_parameters(runs, which):
    if runs[which]["first_error"] is not None:
        raise runs[which]["first_error"]


@pytest.mark.parametrize("which,want", [("even", [10, 8, 0]), ("odd", [15, 12, 0])])
def test_the_step_goes_through_the_fused_blocks(runs, which, want):
    """Calls of the (cmajor, rowmajor, nmajor) entry points: a tower pass is
    (5, 4) and the SR head (0, 0): its head widths 2 and 1 stay unfused (see
    tests/test_torch_port_trainers.py); even = segment_1 + upscale, odd adds
    segment_2."""
    assert runs[which]["calls"] == want


def test_bf16_compute_keeps_fp32_parameters_and_tracks_fp32(lowered_window_rule):
    params = h.jax_params(seed=7, cfg=h.TINY)["params"]
    batch = h.training_batches(1, seed=7)[0]
    traj = {}
    for label, dtype in (("fp32", None), ("bf16", "bfloat16")):
        port = h.tiny_port(params).train()
        trainer = SegmentatorTrainer(port, [batch], num_epochs=1, warmup_epochs=1, lr=1e-3,
                                     compute_dtype=dtype, verbose=False)
        traj[label] = [float(trainer.train_step(*batch)) for _ in range(4)]
        assert all(p.dtype == torch.float32 and p.grad.dtype == torch.float32
                   for p in port.parameters() if p.grad is not None)
        assert all(m.dtype == torch.float32 for m in trainer.optimizer.m)
        assert port.dtype == torch.float32  # the compute dtype is set for the step only
    assert np.all(np.isfinite(traj["bf16"]))
    np.testing.assert_allclose(traj["bf16"], traj["fp32"], rtol=2e-2)
    assert traj["bf16"][-1] < traj["bf16"][0]


def test_bf16_stage3_odd_step_is_finite(lowered_window_rule):
    params = h.jax_params(seed=8, cfg=h.TINY)["params"]
    batch = h.training_batches(1, seed=8)[0]
    port = h.tiny_port(params).train()
    trainer = FullModelTrainer(port, [batch], num_epochs=1, warmup_epochs=1, compute_dtype=torch.bfloat16,
                               verbose=False)
    aux = trainer.train_step(*batch, even=False)
    assert all(np.isfinite(float(aux[k])) for k in ("loss", "seg_lr", "seg_hr"))
    assert all(p.dtype == torch.float32 for p in port.parameters())
