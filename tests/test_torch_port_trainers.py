"""Stage 1 and stage 2 train steps of the port
(swinwnet_tpu_torch/train/trainers.py) against the JAX package's jitted
steps: the same weights and the same two batches; the loss of each step
(1e-4 relative), the first step's gradients leaf by leaf (1e-3 * max|g| per
leaf), and which parameters moved. See tests/_torch_port_train_helpers.py
for how each side runs its fused blocks on the CPU."""

import numpy as np
import pytest
import torch

import _torch_port_helpers as h
import _torch_port_train_helpers as th
from swinwnet_tpu.models import SwinWNet as JaxSwinWNet
from swinwnet_tpu.train.losses import combined_loss, smooth_l1_loss
from swinwnet_tpu.train.trainers import make_stage1_step, make_stage2_step
from swinwnet_tpu_torch.models import BasicLayer
from swinwnet_tpu_torch.ops import swin_block as sb
from swinwnet_tpu_torch.train import SegmentatorTrainer, UpscalerTrainer

torch.set_num_threads(1)

STAGES = {
    "stage1": (make_stage1_step, combined_loss, SegmentatorTrainer, "CombinedLoss",
               ("patch_embed", "segmentator_encoder", "segmentator_bottleneck", "segmentator_decoder",
                "segmentator_head")),
    "stage2": (make_stage2_step, smooth_l1_loss, UpscalerTrainer, "SmoothL1Loss",
               ("upscaler_encoder", "upscaler_bottleneck", "upscaler_decoder", "upscaler_head")),
}


@pytest.fixture(scope="module")
def runs():
    """Both sides run once per stage; the tests read the results."""
    mp = pytest.MonkeyPatch()
    mp.setenv("SWINWNET_FUSED_INTERPRET", "1")
    mp.setenv("SWINWNET_FUSED_DEEP", "1")
    mp.setattr(BasicLayer, "min_windows", 1)
    out = {}
    try:
        params = h.jax_params(seed=5, cfg=h.TINY)["params"]
        batches = h.training_batches(2, seed=5)
        jmodel = JaxSwinWNet(**h.TINY, use_pallas=True)
        for stage, (make_step, jloss, trainer_cls, loss_name, trainable) in STAGES.items():
            jout, jgrads = th.jax_run(stage, lambda tx: (make_step(jmodel, tx, jloss),), params, batches)
            port = h.tiny_port(params).train()
            trainer = trainer_cls(port, batches, loss=loss_name, num_epochs=1, warmup_epochs=1,
                                  lr=th.LR, weight_decay=th.WD, verbose=False)
            sb.reset_counts()
            losses = [trainer.train_step(*batches[0])]
            calls = [k.plain_calls for k in sb.KERNELS]
            first_error = None  # compared now, while the state is that of step 1
            try:
                th.compare_first_step(port, params, jout[0][1], jgrads, trainable)
            except AssertionError as e:  # raised again by the test that reads it
                first_error = e
            losses.append(trainer.train_step(*batches[1]))
            out[stage] = dict(jax=jout, losses=losses, first_error=first_error, calls=calls, trainer=trainer)
        yield out
    finally:
        mp.undo()


@pytest.mark.parametrize("stage", list(STAGES))
def test_losses_of_both_steps(runs, stage):
    r = runs[stage]
    for i, (got, (want, _)) in enumerate(zip(r["losses"], r["jax"])):
        assert np.isfinite(float(got))
        th.assert_loss(got, want, f"{stage} step {i}")


@pytest.mark.parametrize("stage", list(STAGES))
def test_first_step_gradients_and_moved_parameters(runs, stage):
    if runs[stage]["first_error"] is not None:
        raise runs[stage]["first_error"]


@pytest.mark.parametrize("stage,want", [("stage1", [5, 4, 0]), ("stage2", [10, 8, 0])])
def test_the_step_goes_through_the_fused_blocks(runs, stage, want):
    """Calls of the (cmajor, rowmajor, nmajor) entry points in one step, as
    the gate gives them with the window rule lowered. One tower pass at
    widths 12/24/48/96, one block a level and two in the bottleneck:
    encoder 12, 24, 48 cmajor and 96 rowmajor; bottleneck 2 x 96 rowmajor;
    decoder 96 rowmajor, 48 and 24 cmajor: (5, 4). Stage 2 runs the frozen
    segment_1 and the upscaler tower: (10, 8); its head's two levels (6 and
    3 wide, 3 heads: head widths 2 and 1, for which the kernel has no plan)
    run the unfused blocks."""
    assert runs[stage]["calls"] == want


def test_step_count_and_lr_schedule(runs):
    t = runs["stage1"]["trainer"]
    assert t.step == 2 and t.optimizer.count == 2
    assert all(p.dtype == torch.float32 for p in t.model.parameters())
