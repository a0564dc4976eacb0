"""The port stands alone: every module of `swinwnet_tpu_torch` imports, and
it builds a model, serves a request (also through the split route), trains
the three stages, serves an RL request, takes an RL step, runs the
baselines' pipelines and the eval harness on synthesized data, runs the
viewer CLI, the labeler, the C++ batcher, the calibration and the McStas
spec, takes a dropout step, a remat step and a shifted level, and runs the
data-parallel helpers and a one-rank gloo dry run, and runs the quality
recipe at a tiny size, and imports `entry`, and runs the
compiled programs (`core.graphs`: the three inference factories, `TrainState`
and every step and eval factory, the baselines' pipelines, `RLState` and
`make_rl_train_step`), with jax, flax, optax,
orbax and the JAX package refused by an import hook; and its entry points
never quietly fall back to the CPU."""

import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]

BLOCKED_IMPORT = r"""
import importlib.abc, sys

class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        top = name.split(".")[0]
        if top in ("jax", "jaxlib", "flax", "optax", "orbax", "swinwnet_tpu"):
            raise ImportError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, Refuse())
import torch
torch.set_num_threads(1)
import swinwnet_tpu_torch
import importlib, pkgutil
for info in pkgutil.walk_packages(swinwnet_tpu_torch.__path__, "swinwnet_tpu_torch."):
    importlib.import_module(info.name)  # every module of the port, the new ones too
from swinwnet_tpu_torch import apps, compat, core, data, evalharness, models, ops, parallel, physics, pipelines, train, utils
for name in ("ops.resize", "ops.norms", "ops.window", "ops.swin_block", "models.layers", "models.swin_wnet",
             "train.losses", "train.schedule", "train.freeze", "train.trainers", "train.pipeline",
             "utils.logging", "utils.checkpoint", "compat.torch_import", "pipelines.inference",
             "physics.host_oracle", "physics.qwrapper", "physics.emd", "physics.peaks",
             "physics.device_metrics", "physics.metrics", "physics.legacy", "models.alpha_policy",
             "pipelines.rl_inference", "train.rl", "data.generation", "data.noise", "data.loaders",
             "evalharness.image_metrics", "evalharness.harness", "evalharness.regression", "evalharness.plots",
             "utils.debug", "utils.profiling", "models.swin_unet", "pipelines.simple", "pipelines.split",
             "apps.viewer", "apps.viewer_state", "apps.labeler", "apps.labeler_state", "apps.gui",
             "data.native_loader", "data.real", "data.calibration", "data.mcstas", "parallel.multihost",
             "parallel.sharding", "parallel.dryrun", "recipes.quality_run", "recipes.quality_continue",
             "recipes.rl_run", "recipes.classical_baselines", "recipes.train_synthetic",
             "entry", "core.graphs"):
    assert "swinwnet_tpu_torch." + name in sys.modules, name
m = models.SwinWNet(embed_dim=12, depths=(1, 1, 1, 1), num_heads=(3, 3, 3, 3),
                    error_matrix=True, fused_blocks=True, device="cpu")
out = pipelines.SwinWNetInference(m)(torch.rand(1, 1, 20, 30))
assert out.shape == (1, 2, 40, 60), out.shape
loader = [(torch.rand(2, 1, 20, 30).numpy() * 1e3, (torch.rand(2, 20, 30) > 0.5).float().numpy())] * 2
_, hist = train.SwinWNetTrainingPipeline(m, loader, seg_epochs=1, sr_epochs=1, full_epochs=1,
                                         warmup_epochs=1, verbose=False).run()
assert set(hist) == {"stage1", "stage2", "stage3"}, hist
policy = models.AlphaPolicy(device="cpu")
out = pipelines.RLInference(m, policy)(torch.rand(1, 1, 20, 30))
assert out.shape == (1, 2, 40, 60), out.shape
rl = train.RLTrainer(m, policy, [torch.rand(2, 1, 20, 30) * 1e3], num_epochs=1, verbose=False)
assert set(rl.train_epoch()) >= {"reward", "policy_loss", "sup_loss"}
out = pipelines.SwinWNetInference(m, split=True)(torch.rand(1, 1, 20, 30))
assert out.shape == (1, 2, 40, 60), out.shape
unet = models.SwinUNet(in_chans=2, embed_dim=12, depths=(1, 1, 1, 1), num_heads=(3, 3, 3, 3), device="cpu")
assert pipelines.make_segmentation_fn(unet)(torch.rand(1, 2, 20, 30)).shape == (1, 1, 20, 30)
sr = models.SwinUNetSR(embed_dim=12, depths=(1, 1, 1, 1), num_heads=(3, 3, 3, 3), device="cpu")
assert pipelines.make_sr_fn(sr)(torch.rand(1, 1, 20, 30)).shape == (1, 1, 40, 60)
images, masks = data.synthesize_dataset(2, H=20, W=30, seed=0)
calc = evalharness.MetricsCalculator(m, data.ArrayLoader(images, masks, batch_size=2), verbose=False)
assert len(calc.CalculateSegmentationMetrics()["High Res"]["0.50 thrashold"]) == 2
assert len(calc.CalculatePhysycalMetrics()["shape"]) == 2
with utils.nan_check(m):
    utils.assert_finite_pytree(m.state_dict(), "params")
import os, tempfile
import numpy as np
from swinwnet_tpu_torch.apps import gui, labeler_state, viewer
from swinwnet_tpu_torch.data import calibration, mcstas
with tempfile.TemporaryDirectory() as tmp:
    pub = models.SwinWNet(error_matrix=True, device="cpu")
    torch.save({"state_dict": {"module." + k: v for k, v in pub.state_dict().items()}}, tmp + "/m.pth")
    np.save(tmp + "/p.npy", data.synthesize_pattern([1.5, 3.0], [1.0, 0.7], H=20, W=30, seed=1))
    viewer.main(["--weights", tmp + "/m.pth", "--input", tmp + "/p.npy", "--out", tmp + "/out", "--device", "cpu"])
    assert len(os.listdir(tmp + "/out")) == 10, os.listdir(tmp + "/out")
    lab = labeler_state.LabelerModel(device="cpu")
    np.save(tmp + "/d.npy", images)
    lab.load_npy(tmp + "/d.npy")
    assert lab.profile()[1].sum() > 0 and apps.labeler.label_batch(images, [[(1.0, 2.0)], []]).shape == images.shape
nb = data.NativeBatcher(images, masks, batch_size=2, add_noise=True)
assert next(iter(nb))[0].shape == (2, 1, 20, 30)
nb.close()
img = calibration.render_calibrated([1.2, 3.3], [1.0, 0.8], seed=4)
assert calibration.detect_table(img, device="cpu")
assert mcstas.dif60_spec('"Si.laz"', 100.0).detector_component == "Detector"
try:
    gui.build_viewer_window()
except ImportError as e:
    assert "PySide6" in str(e)
d = models.SwinWNet(embed_dim=12, depths=(1, 1, 1, 1), num_heads=(3, 3, 3, 3), drop=0.1, attn_drop=0.1,
                    drop_path=0.1, remat=True, attn_chunk=8, device="cpu")
seg, _ = d.segment_1(torch.rand(1, 1, 20, 30), deterministic=False, generator=torch.Generator().manual_seed(0))
seg.sum().backward()
assert models.BasicLayer(12, 2, 3, shift_size=2)(torch.rand(1, 12, 13, 12)).shape == (1, 12, 13, 12)
assert parallel.initialize_multihost() is False and parallel.process_batch_slice(8, 2, 1) == slice(4, 8)
assert parallel.pad_to_multiple(np.ones((3, 2)), 4)[0].shape == (4, 2)
out = parallel.dryrun_multichip(1, device="cpu", hw=(20, 30), model_kw=dict(
    embed_dim=12, depths=(1, 1, 1, 1), num_heads=(3, 3, 3, 3)))
assert np.isfinite(out["loss"]) and len(out["params"]) > 100
from swinwnet_tpu_torch.recipes import classical_baselines, quality_run
lib = quality_run.make_crystal_library(1)
imgs, msks = quality_run.render_crystals(lib, ["crystal_00"], 1, 20, 30, seed=1)
assert imgs.shape == (1, 20, 30) and msks.any()
assert classical_baselines.maxpool2(imgs[:, None]).shape == (1, 1, 10, 15)
with tempfile.TemporaryDirectory() as tmp:
    summary, _ = quality_run.main(["--tiny", "--device", "cpu", "--loader", "array", "--train-crystals", "2",
                                   "--renders-per-crystal", "1", "--eval-renders-per-crystal", "1", "--seg-epochs",
                                   "1", "--sr-epochs", "1", "--full-epochs", "1", "--noise-passes", "1",
                                   "--out", tmp + "/Q"])
    assert summary["n_eval_samples"] == 6 and os.path.isdir(tmp + "/Q_ckpt")
from swinwnet_tpu_torch import entry as entry_mod
assert entry_mod.dryrun_multichip is parallel.dryrun_multichip
x = torch.rand(1, 1, 20, 30)
assert pipelines.make_inference_fn(m)(x)["images_masked_hr"].shape == (1, 2, 40, 60)
assert pipelines.make_split_inference_fn(m).stage_a(x)[1].shape == (1, 1, 20, 30)
assert pipelines.make_rl_inference_fn(m, policy)(x)["alpha"].shape == (1, 1)
tx = train.masked_adamw(m, "stage3", train.warmup_cosine_schedule(2e-4, 1, 2, 2))
state = train.TrainState.create(m, tx)
batch = (np.random.default_rng(0).uniform(0, 1e3, (2, 1, 20, 30)).astype(np.float32),
         (np.random.default_rng(1).uniform(size=(2, 20, 30)) > 0.5).astype(np.float32))
even, odd, even_eval, odd_eval = train.make_stage3_steps(m, tx, train.combined_loss, train.smooth_l1_loss)
for step, ev in ((train.make_stage1_step(m, tx, train.combined_loss), train.make_stage1_eval(m, train.combined_loss)),
                 (train.make_stage2_step(m, tx, train.smooth_l1_loss), train.make_stage2_eval(m, train.smooth_l1_loss)),
                 (even, even_eval), (odd, odd_eval)):
    state, out = step(state, *batch)
    assert state.opt_state is tx and ev(*batch) is not None
assert int(state.step) == 4
assert pipelines.make_segmentation_fn(unet).program.num_graphs == 0 and pipelines.make_sr_fn(sr).program is not None
mtx, ptx = train.masked_adamw(m, "rl", 1e-5, weight_decay=0.0), train.AdamW(policy.parameters(), 1e-4, weight_decay=0.0)
rl_state = train.RLState(train.TrainState.create(m, mtx), train.TrainState.create(policy, ptx),
                         torch.Generator().manual_seed(0))
rl_step = train.make_rl_train_step(m, policy, mtx, ptx, physics.Qwrapper(fixed_centers=np.linspace(0.05, 7.49, 160),
                                                                          device="cpu"))
rl_state, metrics = rl_step(rl_state, torch.rand(2, 1, 20, 30) * 1e3)
assert int(rl_state.model.step) == int(rl_state.policy.step) == 1 and len(metrics) == 9
assert callable(parallel.data_parallel) and physics.peaks.max_candidates(1241) == 620
bad = [n for n in sys.modules if n.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "orbax", "swinwnet_tpu")]
assert not bad, bad
print("ok")
"""


def test_imports_with_jax_and_jax_package_blocked():
    res = subprocess.run([sys.executable, "-c", BLOCKED_IMPORT], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")


def test_entry_points_need_a_card_unless_cpu_is_asked(monkeypatch):
    from swinwnet_tpu_torch.core import resolve_device
    from swinwnet_tpu_torch.models import SwinUNet, SwinUNetSR, SwinWNet

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        SwinWNet(embed_dim=12, num_heads=(3, 3, 3, 3))
    for baseline in (SwinUNet, SwinUNetSR):
        with pytest.raises(RuntimeError, match="CUDA"):
            baseline(embed_dim=12, num_heads=(3, 3, 3, 3))
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda:0")
    assert resolve_device("cpu").type == "cpu"


def test_rl_and_physics_entry_points_need_a_card_unless_cpu_is_asked(monkeypatch):
    import numpy as np

    from swinwnet_tpu_torch.models import AlphaPolicy
    from swinwnet_tpu_torch.physics import DiffractionMetricsCalculator, Qwrapper
    from swinwnet_tpu_torch.physics.device_metrics import diffraction_metrics_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        AlphaPolicy()
    spectra = np.zeros((1, 160), np.float32)
    with pytest.raises(RuntimeError, match="CUDA"):
        diffraction_metrics_device(spectra, spectra, np.linspace(0.05, 7.49, 160))
    with pytest.raises(RuntimeError, match="CUDA"):
        Qwrapper(fixed_centers=np.linspace(0.05, 7.49, 160)).rebin(np.ones((1, 1, 10, 12), np.float32))
    images = np.ones((1, 1, 10, 12), np.float32)
    with pytest.raises(RuntimeError, match="CUDA"):
        DiffractionMetricsCalculator(np.linspace(0.05, 7.49, 160), np.linspace(0.05, 7.49, 160))(images, images)


def test_apps_and_calibration_need_a_card_unless_cpu_is_asked(monkeypatch, tmp_path):
    import numpy as np

    from swinwnet_tpu_torch.apps.labeler_state import LabelerModel
    from swinwnet_tpu_torch.apps.viewer import load_model_any
    from swinwnet_tpu_torch.apps.viewer_state import ViewerModel
    from swinwnet_tpu_torch.data.calibration import detect_table, extract_crystal_spec

    pth = tmp_path / "m.pth"
    torch.save({}, pth)
    npy = tmp_path / "d.npy"
    np.save(npy, np.ones((1, 10, 12), np.float32))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        load_model_any(str(pth))
    with pytest.raises(RuntimeError, match="CUDA"):
        ViewerModel().load_weights(str(pth))
    viewer = ViewerModel()
    assert viewer.load_npy(str(npy))
    viewer.toggle_stage_selected("images", True)
    with pytest.raises(RuntimeError, match="CUDA"):
        viewer.curves()
    labeler = LabelerModel()
    labeler.load_npy(str(npy))
    with pytest.raises(RuntimeError, match="CUDA"):
        labeler.profile()
    with pytest.raises(RuntimeError, match="CUDA"):
        detect_table(np.ones((10, 12), np.float32))
    with pytest.raises(RuntimeError, match="CUDA"):
        extract_crystal_spec(np.ones((10, 12), np.float32))
