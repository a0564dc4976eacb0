"""The port stands alone: `swinwnet_tpu_torch` imports and builds a model with
jax, flax, optax and the JAX package refused by an import hook; and its
entry points never quietly fall back to the CPU."""

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
        if top in ("jax", "jaxlib", "flax", "optax", "swinwnet_tpu"):
            raise ImportError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, Refuse())
import torch
torch.set_num_threads(1)
import swinwnet_tpu_torch
from swinwnet_tpu_torch import compat, core, models, ops, pipelines
m = models.SwinWNet(embed_dim=12, depths=(1, 1, 1, 1), num_heads=(3, 3, 3, 3),
                    error_matrix=True, fused_blocks=True, device="cpu")
out = pipelines.SwinWNetInference(m)(torch.rand(1, 1, 20, 30))
assert out.shape == (1, 2, 40, 60), out.shape
bad = [n for n in sys.modules if n.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "swinwnet_tpu")]
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
