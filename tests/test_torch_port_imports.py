"""The port stands alone: every module of `swinwnet_tpu_torch` imports, and
it builds a model, serves a request, trains the three stages, serves an RL
request and takes an RL step, with jax, flax, optax, orbax and the JAX
package refused by an import hook; and its entry points never quietly fall
back to the CPU."""

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
from swinwnet_tpu_torch import compat, core, models, ops, physics, pipelines, train, utils
for name in ("ops.resize", "ops.norms", "ops.window", "ops.swin_block", "models.layers", "models.swin_wnet",
             "train.losses", "train.schedule", "train.freeze", "train.trainers", "train.pipeline",
             "utils.logging", "utils.checkpoint", "compat.torch_import", "pipelines.inference",
             "physics.host_oracle", "physics.qwrapper", "physics.emd", "physics.peaks",
             "physics.device_metrics", "physics.metrics", "physics.legacy", "models.alpha_policy",
             "pipelines.rl_inference", "train.rl"):
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
    from swinwnet_tpu_torch.models import SwinWNet

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        SwinWNet(embed_dim=12, num_heads=(3, 3, 3, 3))
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
