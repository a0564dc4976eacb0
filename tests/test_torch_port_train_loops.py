"""The port's epoch loops (swinwnet_tpu_torch/train): best-validation
selection (as tests/test_train.py:223 for the JAX trainers), `save` /
`resume` of the full train state, the three-stage pipeline on a tiny
loader, the JSONL logger, and the rule that a trainer runs on the card
unless its model was built for the CPU."""

import json

import numpy as np
import pytest
import torch

import _torch_port_helpers as h
from swinwnet_tpu_torch.models import SwinWNet
from swinwnet_tpu_torch.train import (
    FullModelTrainer,
    SegmentatorTrainer,
    SwinWNetTrainingPipeline,
    UpscalerTrainer,
)
from swinwnet_tpu_torch.utils import MetricsLogger, latest_checkpoint, load_checkpoint, save_checkpoint

torch.set_num_threads(1)


def tiny_model(seed=0):
    return SwinWNet(**h.TINY, fused_blocks=True, device="cpu", generator=torch.Generator().manual_seed(seed))


def snapshot(model):
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def differs(a, b):
    return any(not torch.equal(a[k], b[k]) for k in a)


def test_keep_best_restores_best_val_params():
    model, loader = tiny_model(), h.training_batches(1)
    t = SegmentatorTrainer(model, loader, val_loader=loader, num_epochs=1, warmup_epochs=1,
                           verbose=False, keep_best=True)
    t._track_best(1.0)  # epoch-0 parameters are the best
    best = snapshot(model)
    t.train_step(*loader[0])  # the parameters move on
    t.history_val.append(1.0)
    t._track_best(2.0)  # worse validation: not recorded
    assert differs(best, snapshot(model))
    t._restore_best()
    assert not differs(best, snapshot(model))
    assert t.best_epoch == 0
    # NaN and the disabled path are no-ops
    t2 = SegmentatorTrainer(model, loader, num_epochs=1, warmup_epochs=1, verbose=False)
    t2._track_best(float("nan"))
    assert t2._best_params is None
    t2._restore_best()


def test_keep_best_end_to_end():
    model, loader = tiny_model(), h.training_batches(1)
    t = SegmentatorTrainer(model, loader, val_loader=loader, num_epochs=2, warmup_epochs=1,
                           verbose=False, keep_best=True)
    hist = t.train()
    assert len(hist["val_loss"]) == 2 and t.best_epoch in (0, 1)
    assert all(np.isfinite(v) for v in hist["val_loss"] + hist["train_loss"])


@pytest.mark.parametrize("cls", [SegmentatorTrainer, UpscalerTrainer, FullModelTrainer])
def test_save_and_resume_round_trip(tmp_path, cls):
    loader = h.training_batches(2)
    a = cls(tiny_model(1), loader, num_epochs=2, warmup_epochs=1, verbose=False)
    step = (lambda t, b: t.train_step(*b, even=True)) if cls is FullModelTrainer else (lambda t, b: t.train_step(*b))
    step(a, loader[0])
    path = a.save(str(tmp_path))
    assert path == latest_checkpoint(str(tmp_path)) and path.endswith("step_00000001.pt")
    b = cls(tiny_model(2), loader, num_epochs=2, warmup_epochs=1, verbose=False)
    assert differs(snapshot(a.model), snapshot(b.model))
    assert b.resume(str(tmp_path))
    assert not differs(snapshot(a.model), snapshot(b.model))
    assert b.step == a.step == 1
    for x, y in zip(a.optimizer.m + a.optimizer.v, b.optimizer.m + b.optimizer.v):
        assert torch.equal(x, y)
    # the resumed run takes the step the first run takes next, bit for bit
    la, lb = step(a, loader[1]), step(b, loader[1])
    la, lb = (la["loss"], lb["loss"]) if isinstance(la, dict) else (la, lb)
    assert torch.equal(la, lb) and not differs(snapshot(a.model), snapshot(b.model))
    assert not cls(tiny_model(3), loader, verbose=False).resume(str(tmp_path / "none"))


def test_checkpoint_files(tmp_path):
    tree = {"a": torch.arange(3.0), "n": {"step": 7}}
    for s in (3, 12):
        save_checkpoint(str(tmp_path), tree, step=s)
    assert latest_checkpoint(str(tmp_path)).endswith("step_00000012.pt")
    back = load_checkpoint(latest_checkpoint(str(tmp_path)))
    assert torch.equal(back["a"], tree["a"]) and back["n"] == {"step": 7}
    assert latest_checkpoint(str(tmp_path / "missing")) is None


def test_pipeline_runs_three_stages(tmp_path):
    model, loader = tiny_model(4), h.training_batches(2)
    before = snapshot(model)
    pipe = SwinWNetTrainingPipeline(model, loader, loader, seg_epochs=1, sr_epochs=2, full_epochs=1,
                                    warmup_epochs=1, verbose=False)
    trained, hist = pipe.run()
    assert trained is model and set(hist) == {"stage1", "stage2", "stage3"}
    assert len(hist["stage1"]["train_loss"]) == 1 and len(hist["stage2"]["train_loss"]) == 2
    assert len(hist["stage3"]["train"]) == 1 and len(hist["stage3"]["val"]) == 1
    assert np.isfinite(hist["stage3"]["train"][0]["loss"]) and np.isfinite(hist["stage3"]["val"][0]["iou_hr"])
    after = snapshot(model)
    assert differs(before, after)
    # stage 3 trains everything, so every tower moved
    for top in ("patch_embed", "segmentator_encoder", "upscaler_head", "ca_seg_to_sr"):
        assert any(not torch.equal(before[k], after[k]) for k in before if k.startswith(top)), top


def test_release_training_state_and_logger(tmp_path):
    log = tmp_path / "m.jsonl"
    loader = h.training_batches(1)
    t = UpscalerTrainer(tiny_model(5), loader, num_epochs=1, warmup_epochs=1, verbose=False, log_path=str(log))
    t.train()
    t.release_training_state()
    assert t.optimizer is None and t.step == 1
    rec = json.loads(log.read_text().splitlines()[0])
    assert rec["step"] == 0 and np.isfinite(rec["train_loss"]) and "wall_time" in rec
    quiet = MetricsLogger(None)
    quiet.log(0, x=1.0)
    quiet.close()


def test_trainers_run_where_the_model_lives(monkeypatch):
    """No card and no request for the CPU: building the model raises, so a
    trainer never starts on the CPU unasked; a CPU model trains on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        SwinWNet(**h.TINY)
    t = SegmentatorTrainer(tiny_model(), h.training_batches(1), num_epochs=1, verbose=False)
    assert float(t.train_step(*h.training_batches(1)[0])) > 0
