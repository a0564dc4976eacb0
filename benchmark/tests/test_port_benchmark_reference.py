"""The frozen reference against the port's plain route, and the comparison
that decides `correct` against a broken timed path and against the
control, at a tiny detector on the CPU."""

from __future__ import annotations

import pytest
import torch

from benchmark.entries import unet_segmentation, wnet_inference, wnet_stage3_trainer
from benchmark.tests.conftest import run_tiny, tiny_cell
from benchmark.yardstick import reference, weights

FP32 = dict(dtype="float32")


def _state(cell, seed=3):
    return weights.draw_state_dict(reference.build(cell.config, "meta"), seed, "cpu")


@pytest.mark.parametrize("workload, entry", [("wnet-serve-b64", wnet_inference), ("unet-seg-b64", unet_segmentation)])
def test_reference_matches_the_ports_plain_route(workload, entry):
    cell = tiny_cell(workload, **FP32)
    sd = _state(cell)
    ref = reference.build(cell.config, "cpu")
    ref.load_state_dict(sd)
    program = entry.Program(cell.config, cell.traffic, sd, "cpu")
    shape = entry.request_shape(cell.config, 2)
    x = torch.rand(shape, generator=torch.Generator().manual_seed(0)) * 500
    got = program(x.numpy())
    want = entry.reference_outputs(ref, x)
    for name in entry.OUTPUTS:
        scale = float(want[name].abs().max())
        assert torch.allclose(got[name], want[name], rtol=0, atol=1e-4 * scale), name


def test_reference_training_step_matches_the_port():
    cell = tiny_cell("wnet-train-s3-b4", **FP32)
    sd = _state(cell)
    program = wnet_stage3_trainer.Program(cell.config, cell.traffic, sd, "cpu")
    ref = wnet_stage3_trainer.Reference(cell.config, cell.traffic, sd, "cpu")
    g = torch.Generator().manual_seed(1)
    images = torch.rand(2, 1, 40, 60, generator=g) * 500
    masks = (torch.rand(2, 40, 60, generator=g) > 0.9).float()
    for k in range(2):
        lp, lr = program.step(images, masks, k % 2 == 0), ref.step(images, masks, k % 2 == 0)
        assert abs(float(lp) - float(lr)) <= 1e-5 * abs(float(lr))
        if k == 0:
            gp, gr = program.first_grad_norms(), ref.first_grad_norms()
            assert gp.keys() == gr.keys()
            assert all(abs(gp[n] - gr[n]) <= 1e-3 * gr[n] + 1e-9 for n in gr)
    cp, cr = program.change_norms(sd), ref.change_norms(sd)
    assert all(abs(cp[n] - cr[n]) <= 1e-3 * cr[n] + 1e-9 for n in cr)


@pytest.mark.parametrize("workload", ["wnet-serve-b64", "unet-seg-b64", "wnet-serve-b1", "wnet-train-s3-b4"])
def test_a_sound_run_is_correct(workload):
    r = run_tiny(tiny_cell(workload))
    assert r["correct"], r["checks"]


@pytest.mark.parametrize("workload", ["wnet-serve-b64", "unet-seg-b64", "wnet-train-s3-b4"])
def test_the_control_is_not_correct(workload):
    """The reference with float8 products in the program's place fails at
    least one of the cell's numbers."""
    r = run_tiny(tiny_cell(workload), control=True)
    assert not r["correct"], r["checks"]


def _wnet_answer_altered(mp):
    from swinwnet_tpu_torch.pipelines import split

    stage_c = split.stage_c
    mp.setattr(split, "stage_c", lambda *a: tuple(t * 1.25 for t in stage_c(*a)))


def _wnet_half_batch(mp):
    from swinwnet_tpu_torch.pipelines import inference, split

    def half(model, images):
        n = len(images) // 2 or 1
        out = split.inference_stages(model, images[:n])
        return {k: torch.cat([v, torch.zeros_like(v[:len(images) - n])]) for k, v in out.items()}

    mp.setattr(inference, "inference_stages", half)


def _unet_answer_altered(mp):
    from swinwnet_tpu_torch.models import swin_unet

    forward = swin_unet.SwinUNet.forward
    mp.setattr(swin_unet.SwinUNet, "forward", lambda self, x, *a: forward(self, x, *a) + 1.0)


def _unet_half_batch(mp):
    from swinwnet_tpu_torch.models import swin_unet

    forward = swin_unet.SwinUNet.forward

    def half(self, x, *a):
        n = len(x) // 2 or 1
        out = forward(self, x[:n], *a)
        return torch.cat([out, torch.zeros_like(out[:len(x) - n])])

    mp.setattr(swin_unet.SwinUNet, "forward", half)


def _train_state_unchanged(mp):
    from swinwnet_tpu_torch.train import freeze

    mp.setattr(freeze.AdamW, "step", lambda self: self.count.add_(1))


def _train_half_batch(mp):
    from swinwnet_tpu_torch.train import trainers

    for name in ("stage3_even_loss", "stage3_odd_loss"):
        loss = getattr(trainers, name)
        mp.setattr(trainers, name, lambda m, s, r, w, images, masks, *a, _l=loss:
                   _l(m, s, r, w, images[:len(images) // 2], masks[:len(masks) // 2], *a))


def _train_answer_altered(mp):
    from swinwnet_tpu_torch.train import trainers

    loss = trainers.stage3_even_loss

    def altered(*a):
        total, aux = loss(*a)
        return total, dict(aux, loss=aux["loss"] * 1.1)

    mp.setattr(trainers, "stage3_even_loss", altered)


FAULTS = [
    ("wnet-serve-b64", _wnet_answer_altered), ("wnet-serve-b64", _wnet_half_batch),
    ("unet-seg-b64", _unet_answer_altered), ("unet-seg-b64", _unet_half_batch),
    ("wnet-serve-b1", _wnet_answer_altered),
    ("wnet-train-s3-b4", _train_state_unchanged), ("wnet-train-s3-b4", _train_half_batch),
    ("wnet-train-s3-b4", _train_answer_altered),
]


@pytest.mark.parametrize("workload, fault", FAULTS, ids=[f"{w}-{f.__name__[1:]}" for w, f in FAULTS])
def test_a_broken_timed_path_is_not_correct(workload, fault, monkeypatch):
    """The harness's run, past its look for a card, with the program broken
    underneath: once for each fault the cell can have (one chip: no
    exchange between chips to leave out)."""
    fault(monkeypatch)
    r = run_tiny(tiny_cell(workload))
    assert not r["correct"], r["checks"]
