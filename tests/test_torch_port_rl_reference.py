"""The REINFORCE fine-tune against its plain reference
(`benchmark/yardstick/ref_swinwnet_rl.py`, plain float32 PyTorch and scipy,
written from the upstream specification), on seeded random weights at a
small detector: the port's step (`RLTrainer.train_step`, eager on the CPU)
step by step, and the port's physics (`Qwrapper.rebin`,
`diffraction_metrics_device`) against the plain reward on seeded spectra
that hold Bragg peaks, including the gates that decide which peaks count."""

import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark.yardstick import ref_swinwnet_rl as ref  # noqa: E402
from benchmark.yardstick import reference, traffic, weights  # noqa: E402
from swinwnet_tpu_torch.models import AlphaPolicy, SwinWNet  # noqa: E402
from swinwnet_tpu_torch.physics import Qwrapper  # noqa: E402
from swinwnet_tpu_torch.physics import device_metrics  # noqa: E402
from swinwnet_tpu_torch.train import RLTrainer  # noqa: E402

torch.set_num_threads(1)

H, W, B = 32, 64, 2
LAMBDAS = dict(lambda_rec=10.0, lambda_intensity=2.0, lambda_peak=1.0, lambda_shape=0.5)
POLICY_LR, MODEL_LR = 1e-4, 1e-5
GRID = np.linspace(0.05318052, 7.49710258, 64)
CFG = dict(architecture="swinwnet_rl", patch_size=2, in_chans=1, error_matrix=True, embed_dim=12,
           depths=[1, 1, 1, 1], num_heads=[3, 6, 12, 24], window_size=5, mlp_ratio=4.0, policy_lr=POLICY_LR,
           model_lr=MODEL_LR, d_centers=[GRID[0], GRID[-1], len(GRID)], **LAMBDAS)
FULL_GRID = np.linspace(0.05318052, 7.49710258, 1241)


def pair(seed):
    """The port's trainer and the reference's step on one drawn state dict,
    a generator for the reference's noise seeded as the trainer's, and the
    drawn state."""
    model = reference.build(CFG, "cpu")
    sd = weights.draw_state_dict(model, seed, "cpu")
    model.load_state_dict(sd)
    port = SwinWNet(**{k: CFG[k] for k in ("patch_size", "in_chans", "error_matrix", "embed_dim", "depths",
                                         "num_heads", "window_size", "mlp_ratio")}, device="cpu")
    port.load_state_dict({k: v for k, v in sd.items() if not k.startswith("policy.")}, strict=False)
    policy = AlphaPolicy(device="cpu")
    policy.load_state_dict({k[len("policy."):]: v for k, v in sd.items() if k.startswith("policy.")})
    trainer = RLTrainer(port, policy, (), d_centers=GRID, policy_lr=POLICY_LR, model_lr=MODEL_LR, seed=seed,
                        verbose=False, **LAMBDAS)
    rl = ref.RLStep(model, CFG)
    return trainer, rl, torch.Generator().manual_seed(seed), {k: v.clone() for k, v in sd.items()}


def close(a, b, rtol, what):
    assert abs(a - b) <= rtol * max(abs(b), 1e-12), (what, a, b)


def leaf_norms(names, opt):
    return {names[id(p)]: float(m.norm()) for p, m in zip(opt.params, opt.m)}


# seed 0: one sample's rollout holds peaks that match the masked image's
# (a non-zero reward); seed 1: no match, a zero reward
@pytest.mark.parametrize("seed", [0, 1])
def test_the_ports_rl_step_matches_the_plain_reference(seed):
    trainer, rl, gen, sd = pair(seed)
    counts, _ = traffic.patterns(traffic.detector({}, dict(height=H, width=W)), 2 * B, seed, "cpu")
    batches = counts[:, None].reshape(2, B, 1, H, W)
    for k in range(2):
        got = {n: float(v) for n, v in trainer.train_step(batches[k]).items()}
        want = rl.step(batches[k], torch.randn((B, 1), generator=gen))
        close(got["reward"], want["reward"], 1e-5, "reward")
        close(got["rec"], want["rec"], 1e-5, "rec")
        close(got["policy_loss"], want["policy_loss"], 1e-5, "policy_loss")
        close(got["alpha_mean"], want["alpha_mean"], 1e-5, "alpha_mean")
        close(got["alpha_std"], want["alpha_std"], 1e-5, "alpha_std")
        if k == 0:
            if seed == 0:
                assert got["reward"] < 0
            names = {id(p): n for n, p in trainer.model.named_parameters()}
            names.update({id(p): "policy." + n for n, p in trainer.policy.named_parameters()})
            ref_names = {id(p): n for n, p in rl.model.named_parameters()}
            for ours, theirs in ((trainer.model_opt, rl.model_opt), (trainer.policy_opt, rl.policy_opt)):
                g, w = leaf_norms(names, ours), leaf_norms(ref_names, theirs)
                assert g.keys() == w.keys()
                scale = max(w.values())
                assert all(abs(g[n] - w[n]) <= 1e-4 * w[n] + 1e-6 * scale for n in w), ours
    # after two steps, by leaf: the norm of the change from the drawn state
    # (an element whose gradient is rounding noise moves by +-lr either way
    # under Adam, so elements are held only to two such steps)
    params = dict(trainer.model.named_parameters())
    params.update({"policy." + n: p for n, p in trainer.policy.named_parameters()})
    for n, p in rl.model.named_parameters():
        lr = POLICY_LR if n.startswith("policy.") else MODEL_LR
        torch.testing.assert_close(params[n].detach(), p.detach(), rtol=0, atol=2.5 * lr, msg=n)
        if p.requires_grad:
            moved, want = float((params[n].detach() - sd[n]).norm()), float((p.detach() - sd[n]).norm())
            assert abs(moved - want) <= 1e-3 * want, (n, moved, want)


def spectra_pairs(seed, n=8):
    """Masked detector patterns at the published size (no model): each
    against a rollout-like copy (a gain and a smooth field added) and
    against the next pattern, as images [n, 1, 250, 480]."""
    counts, _ = traffic.patterns(traffic.detector({}, dict(height=250, width=480)), n, seed, "cpu")
    true = counts[:, None] * 0.5
    g = torch.Generator().manual_seed(seed)
    field = torch.nn.functional.avg_pool2d(torch.rand(n, 1, 270, 500, generator=g), 21, stride=1)
    pred = true * 0.7 + 3 * field * true.mean()
    return [(pred, true), (true, true.roll(1, dims=0))]


def port_reward(pred, true, grid=FULL_GRID, **gates):
    q = Qwrapper(fixed_centers=grid, device="cpu")
    kw = dict(height=0.05, distance=10, prominence=0.1, width=5)
    kw.update(gates)
    m = device_metrics.diffraction_metrics_device(q.rebin(pred), q.rebin(true), q.centers_on("cpu"), **kw)
    return -(2.0 * m["Integral Intensity"] + m["Peak Intensity"] + 0.5 * m["Shape"]).double()


def plain_reward(pred, true, grid=FULL_GRID):
    reward = ref.Reward(grid, LAMBDAS)
    return reward(pred, true)[0], reward


@pytest.mark.parametrize("seed", [12345, 2 ** 40 + 3])
@pytest.mark.parametrize("scale", [None, 0.25])
def test_the_ports_physics_matches_the_plain_reward(seed, scale):
    for pred, true in spectra_pairs(seed):
        if scale is not None:
            _, rl = plain_reward(pred, true)
            s = (scale / rl.rebin(true).amax(dim=1)).float().reshape(-1, 1, 1, 1)
            pred, true = pred * s, true * s
        want, rl = plain_reward(pred, true)
        assert min(len(ref.peak_table(x, FULL_GRID)) for x in rl.rebin(true).numpy()) >= 2
        assert (want < 0).sum() >= 2
        torch.testing.assert_close(port_reward(pred, true), want, rtol=1e-4, atol=1e-6 * float(want.abs().max()))


COARSE_GRID = np.linspace(FULL_GRID[0], FULL_GRID[-1], 249)


@pytest.mark.parametrize("gate, scale, grid", [("distance", None, FULL_GRID), ("distance", None, COARSE_GRID),
                                               ("prominence", 0.25, FULL_GRID)])
def test_a_skipped_gate_changes_the_ports_reward(gate, scale, grid):
    """The gates decide peaks on these spectra: the plain reward and the
    port's with one gate skipped part. The distance gate (10 bins) decides
    on the published grid where a rollout's peaks are close, and on a grid
    5 times coarser between two patterns' reflections."""
    pairs = spectra_pairs(12345, 16)
    pred, true = pairs[0] if grid is FULL_GRID else pairs[1]
    if scale is not None:
        _, reward = plain_reward(pred, true, grid)
        s = (scale / reward.rebin(true).amax(dim=1)).float().reshape(-1, 1, 1, 1)
        pred, true = pred * s, true * s
    want, _ = plain_reward(pred, true, grid)
    torch.testing.assert_close(port_reward(pred, true, grid), want, rtol=1e-4, atol=1e-6 * float(want.abs().max()))
    skipped = port_reward(pred, true, grid, **{gate: 1 if gate == "distance" else -math.inf})
    assert float((skipped - want).abs().max()) > 0.01 * float(want.abs().mean())
