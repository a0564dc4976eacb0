"""The REINFORCE cell at a tiny detector on the CPU: the comparison that
decides `correct` against a sound run, the control and a broken timed path
(each fault the cell can have); the yardstick's RL files against the
program's imports."""

from __future__ import annotations

import math
import time

import pytest

from benchmark import harness
from benchmark.tests.conftest import ROOT
from benchmark.tests.test_port_benchmark_imports import _imports

# 32 x 64 at the published widths, B=2, in fp32 (as the tiny stage-3 cell:
# bf16 at this size reads above limits set at B=4 on the full detector),
# and a grid of 512 bins, on which a rollout of the seed's weights holds a
# peak that matches one of its masked image: a reward that is not 0, so
# that the policy's update is held too
TINY = {"height": 32, "width": 64}
CONFIG = dict(TINY, dtype="float32", d_centers=[0.05318052, 7.49710258, 512])
SEED = 2 ** 31 + 18


def tiny_cell() -> harness.Cell:
    cell = harness.load_cell("wnet-rl-step-b4")
    cell.config = {**cell.config, **CONFIG}
    cell.traffic = dict(cell.traffic, batch=2, pool=8, detector=dict(TINY))
    cell.end_to_end, cell.per_layer = [], []
    return cell


def run_tiny(control: bool = False) -> dict:
    return harness.run_cell(tiny_cell(), SEED, 0.3, False, "cpu", time.perf_counter(), control=control)


def test_a_sound_run_is_correct():
    r = run_tiny()
    assert r["correct"], r["checks"]
    assert r["attempted"] >= 1


def test_the_control_is_not_correct():
    r = run_tiny(control=True)
    assert not r["correct"], r["checks"]


def _half_batch(mp):
    from swinwnet_tpu_torch.train import rl

    step = rl.rl_step
    mp.setattr(rl, "rl_step", lambda m, p, mo, po, q, images, noise, **kw:
               step(m, p, mo, po, q, images[:len(images) // 2], noise[:len(noise) // 2], **kw))


def _gate_skipped(**gate):
    def fault(mp):
        from swinwnet_tpu_torch.physics import device_metrics

        find = device_metrics.find_peaks_device
        mp.setattr(device_metrics, "find_peaks_device", lambda I, **kw: find(I, **{**kw, **gate}))

    return fault


def _noise_dropped(mp):
    import torch
    from swinwnet_tpu_torch.train import rl

    mp.setattr(rl, "draw_noise", lambda rng, batch, device: torch.zeros((batch, 1), device=device))


class _Unstepped:
    """An optimizer whose step does nothing."""

    def __init__(self, opt):
        self.opt = opt

    def zero_grad(self):
        self.opt.zero_grad()

    def step(self):
        pass


def _policy_update_skipped(mp):
    from swinwnet_tpu_torch.train import rl

    step = rl.rl_step
    mp.setattr(rl, "rl_step", lambda m, p, mo, po, q, images, noise, **kw:
               step(m, p, mo, _Unstepped(po), q, images, noise, **kw))


def _reward_grid_stale(mp):
    """The step's reward binned on a grid of every other centre."""
    from swinwnet_tpu_torch.train import rl

    make = rl.Qwrapper
    mp.setattr(rl, "Qwrapper", lambda fixed_centers, **kw: make(fixed_centers=fixed_centers[::2], **kw))


FAULTS = {"half_batch": _half_batch, "distance_gate_skipped": _gate_skipped(distance=1),
          "prominence_gate_skipped": _gate_skipped(prominence=-math.inf), "noise_dropped": _noise_dropped,
          "policy_update_skipped": _policy_update_skipped, "reward_grid_stale": _reward_grid_stale}


@pytest.mark.parametrize("fault", ["half_batch", "noise_dropped", "policy_update_skipped", "reward_grid_stale"])
def test_a_broken_timed_path_is_not_correct(fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    r = run_tiny()
    assert not r["correct"], r["checks"]


class _Rollouts:
    """What `physics_gap` reads of the reference's step: rollouts at the
    published detector (the masked patterns with a gain and a smooth field,
    no model), its reward and the lambdas."""

    def __init__(self, config: dict, seed: int):
        import numpy as np
        import torch

        from benchmark.yardstick import ref_swinwnet_rl, traffic

        counts, _ = traffic.patterns(traffic.detector({}, config), 16, seed, "cpu")
        true = counts[:, None] * 0.5
        field = torch.nn.functional.avg_pool2d(
            torch.rand(16, 1, true.shape[2] + 20, true.shape[3] + 20, generator=torch.Generator().manual_seed(seed)),
            21, stride=1)
        pred = true * 0.7 + 3 * field * true.mean()
        self.lambdas = {k: config[k] for k in ("lambda_rec", "lambda_intensity", "lambda_peak", "lambda_shape")}
        self.reward = ref_swinwnet_rl.Reward(np.linspace(*config["d_centers"]), self.lambdas)
        self.rollouts = [(pred[k:k + 4], true[k:k + 4]) for k in range(0, 16, 4)]


@pytest.mark.parametrize("fault", [None, "distance_gate_skipped", "prominence_gate_skipped"])
def test_the_physics_check_fails_a_skipped_gate(fault, monkeypatch):
    """At the published detector and grid (the physics alone, on the CPU):
    sound, the port's reward is the plain one's; with a gate skipped, the
    physics number is past its limit."""
    from benchmark.entries import wnet_rl_trainer
    from benchmark.loops import rl_steps

    cell = harness.load_cell("wnet-rl-step-b4")
    data = _Rollouts(cell.config, 2200000302)
    if fault:
        FAULTS[fault](monkeypatch)
    gap = rl_steps.physics_gap(cell.config, wnet_rl_trainer, data)
    assert (gap <= cell.limits["physics"]) == (fault is None), gap


@pytest.mark.parametrize("name", ["ref_swinwnet_rl.py", "flops_rl.py"])
def test_the_rl_yardstick_imports_nothing_of_the_program(name):
    path = ROOT / "benchmark" / "yardstick" / name
    tops = {m.split(".")[0] for m in _imports(path)}
    assert "scipy" in tops or name == "flops_rl.py"
    assert not tops & {"swinwnet_tpu_torch", "swinwnet_tpu", "jax", "jaxlib", "flax", "optax"}, tops
