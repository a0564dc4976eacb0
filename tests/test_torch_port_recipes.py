"""The user's recipes (swinwnet_tpu_torch/recipes) against the JAX scripts
they port, loaded from scripts/ as they stand: the crystal library and its
renders bit for bit, `TrainConfig`, the quality run's pipeline arguments
and input pipeline, tiny fp32 training through the three stages against
the JAX pipeline on the same weights and batches, a bf16 step with remat
(whose recompute the trainers once ran in fp32), and the rule
that every recipe runs on the card unless asked for the CPU.

Tolerances: the renders are numpy on both sides and equal bit for bit; the
training histories within 1e-4 relative (fp32 in other summation orders,
as tests/test_torch_port_trainers*.py); remat against no remat equal to
fp32 rounding of the same bf16 arithmetic (1e-6 of each gradient's max)."""

import dataclasses
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_port_recipe_helpers as r
from swinwnet_tpu.core import TrainConfig as JaxTrainConfig
from swinwnet_tpu.models import SwinWNet as JaxSwinWNet
from swinwnet_tpu_torch.core import TrainConfig
from swinwnet_tpu_torch.models import SwinWNet
from swinwnet_tpu_torch.recipes import classical_baselines, quality_continue, quality_run, rl_run, train_synthetic
from swinwnet_tpu_torch.train import FullModelTrainer, SegmentatorTrainer, UpscalerTrainer

torch.set_num_threads(1)

REMAT_TOL = 1e-6


def assert_libraries_equal(got, want):
    assert list(got) == list(want)
    for name in want:
        assert set(got[name]) == set(want[name]), name
        for k, v in want[name].items():
            assert np.array_equal(np.asarray(got[name][k]), np.asarray(v)), (name, k)


@pytest.mark.parametrize("n_train", [0, 8])
def test_crystal_library_is_the_jax_scripts(n_train):
    assert quality_run.HELD_OUT == r.JAX_QR.HELD_OUT
    assert (quality_run.EVAL_STATS, quality_run.TRAIN_STATS, quality_run.PULSES_US) == (
        r.JAX_QR.EVAL_STATS, r.JAX_QR.TRAIN_STATS, r.JAX_QR.PULSES_US)
    assert_libraries_equal(quality_run.make_crystal_library(n_train, seed=0),
                           r.JAX_QR.make_crystal_library(n_train, seed=0))


@pytest.mark.parametrize("which, hw, renders", [
    ("train", (50, 60), 2),
    ("held_out", (50, 60), 1),
    ("one train crystal", (250, 480), 1),
])
def test_renders_are_the_jax_scripts(which, hw, renders):
    lib = quality_run.make_crystal_library(8, seed=0)
    names = {"train": [n for n in lib if n not in quality_run.HELD_OUT], "held_out": list(quality_run.HELD_OUT),
             "one train crystal": ["crystal_03"]}[which]
    seed = 2 if which == "held_out" else 1
    got = quality_run.render_crystals(lib, names, renders, *hw, seed=seed)
    want = r.JAX_QR.render_crystals(r.JAX_QR.make_crystal_library(8, seed=0), names, renders, *hw, seed=seed)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape and np.array_equal(g, w)
    assert got[1].any() and got[0].shape == (len(names) * renders, *hw)


def test_train_config_is_the_jax_one():
    fields = lambda cls: [(f.name, f.type, f.default) for f in dataclasses.fields(cls)]
    assert fields(TrainConfig) == fields(JaxTrainConfig)
    assert TrainConfig() == TrainConfig(**dataclasses.asdict(JaxTrainConfig()))


class _Captured(Exception):
    pass


@pytest.mark.parametrize("argv", [
    ["--compute-dtype", "fp32"],
    ["--compute-dtype", "bf16", "--sr-loss", "SmoothL1SSIMLoss", "--keep-best", "--flip-augment"],
])
def test_pipeline_arguments_and_loaders_are_the_jax_scripts(monkeypatch, argv):
    """The JAX script's main up to its pipeline, which is replaced by a
    probe: its keyword arguments and loaders against the recipe's."""
    import swinwnet_tpu.train

    seen = {}

    def probe(model, params, train_loader, val_loader, **kw):
        seen.update(kw, train_loader=train_loader, val_loader=val_loader)
        raise _Captured

    # --loader array: the JAX script asks whether its C++ batcher builds before
    # it reads --flip-augment, and a build would write into the JAX package
    common = ["--tiny", "--loader", "array", "--train-crystals", "1", "--renders-per-crystal", "1",
              "--eval-renders-per-crystal", "1", "--seg-epochs", "3", "--sr-epochs", "2", "--full-epochs", "4",
              "--warmup-epochs", "2"]
    monkeypatch.setenv("SWINWNET_COMPILE_CACHE", "0")
    monkeypatch.setattr(swinwnet_tpu.train, "SwinWNetTrainingPipeline", probe)
    # the probe takes no weights: skip the JAX model's init and its compile
    monkeypatch.setattr(JaxSwinWNet, "init", lambda self, *a, **kw: {"params": None})
    monkeypatch.setattr(sys, "argv", ["quality_run.py", *common, *argv])
    with pytest.raises(_Captured):
        r.JAX_QR.main()
    args = quality_run.parse_args([*common, *argv, "--device", "cpu"])
    want = {k: v for k, v in seen.items() if not k.endswith("_loader")}
    want["compute_dtype"] = {None: None, jnp.bfloat16: "bfloat16"}[want["compute_dtype"]]
    assert quality_run.pipeline_kwargs(args) == want

    args.height, args.width = quality_run.TINY_HW
    data = quality_run.render_data(args)
    train_loader, val_loader, kind = quality_run.make_loaders(args, *data[1:])
    assert kind == "array" and type(seen["train_loader"]).__name__ == "ArrayLoader"
    for got, ref in ((train_loader, seen["train_loader"]), (val_loader, seen["val_loader"])):
        assert (got.batch_size, got.shuffle, got.joint_augment is None) == (
            ref.batch_size, ref.shuffle, ref.joint_augment is None)
        for (gi, gm), (ri, rm) in zip(got, ref):  # the same batches, augmentations and all
            assert np.array_equal(gi, ri) and np.array_equal(gm, rm)


def test_fp32_training_matches_the_jax_pipeline():
    args = r.tiny_args("--compute-dtype", "fp32", "--sr-loss", "SmoothL1SSIMLoss", "--keep-best")
    data = quality_run.render_data(args)
    model = quality_run.build_model(args, "cpu")
    want = r.jax_histories(args, model, data, None)
    got = quality_run.train(args, model, *quality_run.make_loaders(args, *data[1:])[:2])
    n = 0
    for name, g, w in r.history_pairs(got, want):
        assert np.isfinite(g) and abs(g - float(w)) <= r.HIST_RTOL * max(abs(float(w)), 1e-6), (name, g, w)
        n += 1
    assert n == 4 + 2 * 5


def grads(model):
    return {k: p.grad.clone() for k, p in model.named_parameters() if p.grad is not None}


@pytest.mark.parametrize("stage", ["stage1", "stage2", "stage3_even", "stage3_odd"])
def test_bf16_step_with_remat_recomputes_in_bf16(stage):
    """A bf16 step of a model built with remat: the recompute in the
    backward runs in the forward's dtype (the trainers once
    ran it in fp32 and autograd refused the step), and its gradients are
    those of the same step without remat."""
    batch = next(iter(quality_run.make_loaders(r.tiny_args(), *quality_run.render_data(r.tiny_args())[1:])[0]))
    out = {}
    for remat in (False, True):
        model = quality_run.new_model(quality_run.TINY, "cpu", remat=remat).train()
        cls = {"stage1": SegmentatorTrainer, "stage2": UpscalerTrainer}.get(stage, FullModelTrainer)
        trainer = cls(model, [batch], num_epochs=1, warmup_epochs=1, compute_dtype="bfloat16", verbose=False)
        if cls is FullModelTrainer:
            loss = trainer.train_step(*batch, even=stage == "stage3_even")["loss"]
        else:
            loss = trainer.train_step(*batch)
        out[remat] = float(loss), grads(model)
    assert out[True][0] == out[False][0] and np.isfinite(out[True][0])
    assert out[True][1].keys() == out[False][1].keys() and len(out[True][1]) > 10
    for k, g in out[False][1].items():
        assert (out[True][1][k] - g).abs().max() <= REMAT_TOL * max(g.abs().max().item(), 1e-30), k


@pytest.mark.parametrize("recipe", [quality_run, quality_continue, rl_run, classical_baselines, train_synthetic])
def test_recipes_need_a_card_unless_cpu_is_asked(monkeypatch, tmp_path, recipe):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="CUDA"):
        recipe.main(["--out", str(tmp_path / "out")])
    assert not any(tmp_path.iterdir())
    assert recipe.parse_args(["--device", "cpu"]).device == "cpu"


def test_build_model_is_the_published_or_tiny_architecture():
    args = r.tiny_args()
    tiny = quality_run.build_model(args, "cpu")
    assert isinstance(tiny, SwinWNet) and tiny.patch_embed.proj.weight.shape[0] == 12
    args.tiny = False
    published = quality_run.build_model(args, "cpu")
    assert published.patch_embed.proj.weight.shape[0] == 48
    levels = [m for m in published.modules() if hasattr(m, "remat")]
    attns = [m for m in published.modules() if hasattr(m, "attn_chunk")]
    assert levels and all(m.remat for m in levels) and attns and all(m.attn_chunk == 8192 for m in attns)
    assert not any(m.remat for m in tiny.modules() if hasattr(m, "remat"))
    # the same seed draws the same weights
    again = quality_run.build_model(args, "cpu")
    assert all(torch.equal(a, b) for a, b in zip(published.state_dict().values(), again.state_dict().values()))
