"""The five recipes (swinwnet_tpu_torch/recipes) run end to end on the CPU
at a tiny size, chained as a user chains them: the quality run writes its
summary, metric files and checkpoint; the continuation, the RL run and the
classical baselines with the checkpoint's masks start from that
checkpoint; the synthetic example runs alone. Each writes the files its
JAX script writes, with the JAX script's keys: the summaries' keys are read
from the scripts' own `summary = {...}` literals, and the key trees of the
metric files and summaries are those of the committed QUALITY_r05*,
QUALITY_r03_cont and CLASSICAL_r04_syn files. And each runs as
`python -m swinwnet_tpu_torch.recipes.<name>`."""

import ast
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import _torch_port_recipe_helpers as r
from swinwnet_tpu_torch.recipes import classical_baselines, quality_continue, quality_run, rl_run, train_synthetic

torch.set_num_threads(1)

SMALL = ["--device", "cpu", "--train-crystals", "4", "--renders-per-crystal", "2", "--eval-renders-per-crystal", "1",
         "--noise-passes", "1"]
GEOMETRY = ["--height", "50", "--width", "60"]


def jax_summary_keys(script):
    """The keys of the `summary = {...}` literal in scripts/<script>.py."""
    tree = ast.parse((r.SCRIPTS / f"{script}.py").read_text())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and any(isinstance(t, ast.Name) and t.id == "summary" for t in node.targets)):
            return [k.value for k in node.value.keys]
    raise AssertionError(f"no summary literal in {script}")


def committed(name):
    with open(r.REPO / name) as f:
        return json.load(f)


def key_tree(x, depth=3):
    """Nested dict keys down to `depth`; a list stands for its first item's tree."""
    if depth == 0:
        return None
    if isinstance(x, dict):
        return {k: key_tree(v, depth - 1) for k, v in x.items()}
    if isinstance(x, list) and x and isinstance(x[0], dict):
        return [key_tree(x[0], depth - 1)]
    return None


@pytest.fixture(scope="module")
def quality(tmp_path_factory):
    """One tiny quality run: (its directory, its summary, seconds by part)."""
    out = tmp_path_factory.mktemp("quality")
    summary, seconds = quality_run.main(["--tiny", *SMALL, "--loader", "array", "--seg-epochs", "1", "--sr-epochs",
                                         "1", "--full-epochs", "1", "--warmup-epochs", "1", "--keep-best",
                                         "--out", str(out / "Q")])
    return out, summary, seconds


def test_quality_run_writes_the_jax_scripts_files(quality):
    out, summary, seconds = quality
    assert list(summary) == jax_summary_keys("quality_run")
    assert json.loads((out / "Q.json").read_text()).keys() == summary.keys()
    assert set(seconds) == {"render", "train", "eval", "diagnostics"}
    for kind in ("segmentation", "upscaling", "physical"):
        got = json.loads((out / f"Q_{kind}_metrics.json").read_text())
        assert key_tree(got) == key_tree(committed(f"QUALITY_r05_{kind}_metrics.json")), kind
    phys = json.loads((out / "Q_physical_metrics.json").read_text())
    assert all(len(v) == 6 for v in phys.values())
    assert summary["n_eval_samples"] == 6 and summary["geometry"] == [50, 60]
    assert summary["input_pipeline"] == "array" and summary["real_eval"] is None
    assert summary["recipe"] == {"epochs": [1, 1, 1], "compute_dtype": "bf16", "sr_loss": "SmoothL1Loss",
                                 "keep_best": True, "flip_augment": False}
    assert key_tree(summary["diagnostics"]) == key_tree(committed("QUALITY_r05.json")["diagnostics"])
    assert os.listdir(out / "Q_ckpt") == ["step_00000000.pt"]


def test_the_checkpoint_holds_the_evaluated_model(quality):
    """The checkpoint loads into the architecture it names, and the model
    it gives has the diagnostics of the run's summary."""
    out, summary, _ = quality
    args = r.tiny_args("--eval-renders-per-crystal", "1", "--train-crystals", "4")
    model, path, tree = quality_run.load_model(str(out / "Q_ckpt"), "cpu")
    assert path.endswith("step_00000000.pt") and tree["model"] == quality_run.TINY
    _, _, _, images, _ = quality_run.render_data(args)
    assert quality_run.diagnostics(model, images, args.batch) == summary["diagnostics"]
    with pytest.raises(FileNotFoundError):
        quality_run.load_model(str(out / "none"), "cpu")


def test_quality_continue_from_the_checkpoint(quality):
    out, _, _ = quality
    summary = quality_continue.main(["--ckpt", str(out / "Q_ckpt"), "--out", str(out / "Q"), *SMALL, *GEOMETRY,
                                     "--sr-epochs", "1", "--full-epochs", "1", "--compute-dtype", "fp32"])
    assert list(summary) == jax_summary_keys("quality_continue") == list(committed("QUALITY_r03_cont.json"))
    assert summary["continued_from"].endswith("Q_ckpt/step_00000000.pt")
    assert summary["extra_epochs"] == {"sr": 1, "full": 1} and summary["n_eval_samples"] == 6
    for kind in ("segmentation", "upscaling", "physical"):
        got = json.loads((out / f"Q_cont_{kind}_metrics.json").read_text())
        assert key_tree(got) == key_tree(committed(f"QUALITY_r03_cont_{kind}_metrics.json")), kind
    assert os.listdir(out / "Q_ckpt_cont") == ["step_00000000.pt"]
    before = quality_run.load_model(str(out / "Q_ckpt"), "cpu")[0].state_dict()
    after = quality_run.load_model(str(out / "Q_ckpt_cont"), "cpu")[0].state_dict()
    moved = {k.split(".")[0] for k in before if not torch.equal(before[k], after[k])}
    assert "upscaler_head" in moved and "segmentator_encoder" in moved  # stage 3 trains everything


def test_rl_run_from_the_checkpoint(quality):
    out, _, _ = quality
    summary = rl_run.main(["--ckpt", str(out / "Q_ckpt"), "--out", str(out / "R"), *SMALL, *GEOMETRY,
                           "--epochs", "2", "--ablation-gains", "0.45,0.55"])
    want = committed("QUALITY_r05_rl.json")
    assert list(summary) == jax_summary_keys("rl_run") == list(want)
    assert summary["final_epoch_metrics"].keys() == want["final_epoch_metrics"].keys()
    assert summary["alpha"].keys() == want["alpha"].keys()
    assert summary["physical_pre"].keys() == summary["physical_post"].keys() == want["physical_pre"].keys()
    grid = summary["ablation_constant_gain"]["grid"]
    assert list(grid) == list(want["ablation_constant_gain"]["grid"]) == ["pre_model", "post_model"]
    assert [list(g) for g in grid.values()] == [["0.45", "0.55"]] * 2
    assert len(summary["reward_curve"]) == 2 and all(np.isfinite(v) for v in summary["reward_curve"])
    assert 0.0 < summary["alpha"]["gain_min"] <= summary["alpha"]["gain_max"] < 1.0
    phys = json.loads((out / "R_physical_metrics.json").read_text())
    assert phys.keys() == committed("QUALITY_r05_rl_physical_metrics.json").keys()
    ckpt = torch.load(out / "R_ckpt" / "step_00000000.pt", weights_only=True)
    assert set(ckpt) == {"params", "policy", "model"} and set(ckpt["policy"]) == {
        "conv.weight", "conv.bias", "fc.weight", "fc.bias"}


def test_classical_baselines_with_the_checkpoints_masks(quality):
    out, _, _ = quality
    flags = ["--data", "synthetic", "--device", "cpu", *GEOMETRY, "--eval-renders-per-crystal", "1",
             "--noise-passes", "1", "--baselines", str(out / "none")]
    gt = classical_baselines.main([*flags, "--out", str(out / "Cgt")])
    ck = classical_baselines.main([*flags, "--mask", "ckpt", "--ckpt", str(out / "Q_ckpt"), "--out", str(out / "Cck")])
    assert list(ck) == jax_summary_keys("classical_baselines") == list(committed("CLASSICAL_r04_syn.json"))
    assert (gt["mask_source"], ck["mask_source"]) == ("gt", "ckpt") and ck["n_samples"] == 6
    for name in ("bilinear", "avgpool"):
        for kind in ("physical_metrics", "peak_losses"):
            got = json.loads((out / f"Cck_{name}_{kind}.json").read_text())
            assert got.keys() == committed(f"CLASSICAL_r04_syn_{name}_{kind}.json").keys()
    with pytest.raises(ValueError, match="--ckpt"):
        classical_baselines.main([*flags, "--mask", "ckpt", "--out", str(out / "Cnone")])


@pytest.mark.parametrize("matplotlib", [True, False])
def test_train_synthetic_writes_the_examples_files(monkeypatch, tmp_path, matplotlib):
    """The example's files; without matplotlib (the card's machine has
    none) every file but the plot."""
    if not matplotlib:
        def no_plot(*a, **kw):
            raise ImportError("No module named 'matplotlib'")
        monkeypatch.setattr(train_synthetic, "plot_metric_distributions", no_plot)
    histories, rl_history = train_synthetic.main(["--tiny", "--device", "cpu", "--samples", "8", "--epochs", "1",
                                                  "--out", str(tmp_path / "syn")])
    assert set(histories) == {"stage1", "stage2", "stage3"} and len(rl_history) == 1
    plot = ["physical_metrics.png"] if matplotlib else []
    assert sorted(os.listdir(tmp_path / "syn")) == sorted(["checkpoints", "physycal_metrics.json",
                                                           "segmentation_metrics.json", "upscaling_metrics.json", *plot])
    seg = json.loads((tmp_path / "syn" / "segmentation_metrics.json").read_text())
    assert list(seg) == ["metrics_25", "metrics_50", "metrics_75"] and len(seg["metrics_50"]) == 2
    assert os.listdir(tmp_path / "syn" / "checkpoints") == ["step_00000000.pt"]


def test_recipes_run_as_modules():
    """`python -m swinwnet_tpu_torch.recipes.<name> --help`, all five in one
    interpreter through runpy, which runs each module as __main__."""
    code = """
import runpy, sys
for name in ("quality_run", "quality_continue", "rl_run", "classical_baselines", "train_synthetic"):
    sys.argv = [name, "--help"]
    try:
        runpy.run_module("swinwnet_tpu_torch.recipes." + name, run_name="__main__", alter_sys=True)
    except SystemExit as e:
        assert e.code == 0, (name, e.code)
    else:
        raise AssertionError(name + " did not parse --help")
"""
    res = subprocess.run([sys.executable, "-c", code], cwd=r.REPO, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    for flag in ("--device", "--fused-blocks"):  # once in each option list
        assert len(re.findall(rf"^\s+{flag}\b", res.stdout, flags=re.M)) == 5, flag
