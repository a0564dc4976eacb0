"""REINFORCE steps: one RL trainer stepping over a device-resident pool of
seeded patterns [pool, 1, H, W] (the error channel is made in the step), a
batch of consecutive rows a step, back to back, and reading the step's nine
metrics on the host as the trainer's epoch loop does. The trainer's noise
generator is seeded from the seed.

Set-up builds the trainer once and drives it through its first
`check_steps` steps on rows that all differ (the comparison follows them:
the first is the program's eager warm-up, the rest its graph's first
replays), then `warm_steps` more; the window continues from there with the
same trainer and the same feed.
"""

from __future__ import annotations

import json
import math
import statistics
import sys
import time
from typing import Dict, List

import numpy as np
import torch
from torch.profiler import record_function

from ..yardstick import compare, ref_swinwnet_rl, traffic as traffic_gen
from ..yardstick.weights import sub_seed

NOISE = 4  # the stream of the action's noise (weights.py draws streams 1-3)
# The reward's gates are absolute (height 0.05, prominence 0.1): on spectra
# of counts every Bragg peak clears them by far. Scaled so that the largest
# bin is 0.25, the weaker reflections (intensities span a factor of 6) fall
# between them, so that those gates decide peaks.
GATE_SCALE = 0.25
# The distance gate (10 bins) decides where peaks lie closer than that: on a
# grid 5 times coarser than the published one (0.030 A a bin), reflections
# 0.25 A apart (the patterns' least separation) lie 8 bins apart.
COARSE = 5


class RLLoop:
    def __init__(self, cell, program, seed: int, device):
        self.cell, self.program, self.device = cell, program, device
        t = cell.traffic
        self.batch, self.pool = t["batch"], t["pool"]
        if self.pool % self.batch or self.pool < self.batch * t["check_steps"]:
            raise ValueError(f"pool {self.pool} must be a multiple of the batch {self.batch} and hold "
                             f"{t['check_steps']} distinct batches")
        counts, _ = traffic_gen.patterns(traffic_gen.detector(t, cell.config), self.pool, seed, device)
        self.images = counts[:, None].contiguous()
        self.noise_seed = sub_seed(seed, NOISE)
        program.seed_noise(self.noise_seed)
        self.k = 0
        self.first: Dict[str, object] = {}

    def _rows(self, k: int) -> torch.Tensor:
        i = (k * self.batch) % self.pool
        return self.images[i:i + self.batch]

    def _step(self) -> Dict[str, float]:
        with record_function("bench.step"):
            metrics = self.program.step(self._rows(self.k))
        self.k += 1
        return {k: float(v) for k, v in metrics.items()}

    def warm(self, state_dict: Dict[str, torch.Tensor]) -> None:
        """The first steps, read for the comparison (with the rollout each
        rewarded), then the warm-up."""
        t = self.cell.traffic
        steps: List[Dict[str, float]] = []
        rollouts: List[Dict[str, torch.Tensor]] = []
        for j in range(t["check_steps"]):
            steps.append(self._step())
            rollouts.append(self.program.rollout())
            if j == 0:
                self.first["grad"] = self.program.first_grad_norms()
        self.first["steps"], self.first["rollouts"] = steps, rollouts
        grad = self.first["grad"]
        self.first["change"] = self.program.change_norms({n: state_dict[n] for n in [*grad["model"], *grad["policy"]]})
        for _ in range(t["warm_steps"]):
            self._step()

    def window(self, seconds: float) -> dict:
        failed, steps = 0, 0
        t0 = time.perf_counter_ns()
        start = time.perf_counter()
        while True:
            with record_function("bench.read_metrics"):
                metrics = self._step()
            failed += not all(math.isfinite(v) for v in metrics.values())
            steps += 1
            if time.perf_counter() - start >= seconds:
                break
        elapsed = time.perf_counter() - start
        print_spans(t0)
        return {"kind": "train", "calls": steps, "failed": failed, "images": self.batch * steps,
                "batch": self.batch, "elapsed_s": elapsed}

    def traced_slice(self, steps: int) -> int:
        for _ in range(steps):
            self._step()
        return steps * self.batch

    def check(self, start: Dict[str, torch.Tensor]) -> Dict[str, float]:
        """The reference follows the first steps on the same rows and noise,
        its policy's update weighed by the plain reward of the program's own
        rollouts (`reward`: the program's per-sample rewards against that);
        the port's physics is held against the plain reward on the
        reference's data. The L1 reconstruction and the reference's own
        rewards are read beside the numbers compared, not compared: the
        float8 control's L1 straddles the sound runs' (PERF.md), and where a
        peak of a rollout sits at a gate, bf16 and float32 rollouts land on
        its two sides."""
        t, cfg = self.cell.traffic, self.cell.config
        reference = self.cell.entry.Reference(cfg, t, start, self.device)
        reference.seed_noise(self.noise_seed)
        plain = [reference.rl.reward(r["pred"], r["true"])[0] for r in self.first["rollouts"]]
        steps = []
        for k in range(t["check_steps"]):
            rows = self._rows(k)
            # a rollout of another batch than the rows' weighs nothing: the reference keeps its own reward
            given = plain[k] if len(plain[k]) == len(rows) else None
            steps.append({n: float(v) for n, v in reference.step(rows, given).items()})
            if k == 0:
                grad = reference.first_grad_norms()
        self.reference_steps = steps
        got = self.first["steps"]
        change = reference.change_norms({n: start[n] for n in [*grad["model"], *grad["policy"]]})
        numbers = {
            "action": max(max(abs(g["alpha_mean"] - r["alpha_mean"]), abs(g["alpha_std"] - r["alpha_std"]))
                          / max(r["alpha_std"], 1e-30) for g, r in zip(got, steps)),
            "reward": reward_gap([r["reward"] for r in self.first["rollouts"]], plain),
            "model_first_grad": compare.leaf_gap(self.first["grad"]["model"], grad["model"]),
            "policy_first_grad": compare.leaf_gap(self.first["grad"]["policy"], grad["policy"]),
            "change": compare.leaf_gap(self.first["change"], change, compare.moving_leaves(grad["model"])),
            "policy_change": compare.leaf_gap(self.first["change"], change, list(grad["policy"])),
            "physics": physics_gap(cfg, self.cell.entry, reference.rl),
        }
        self.read = {"rec": compare.loss_gap([s["rec"] for s in got], [s["rec"] for s in steps]),
                     "rewarded": sum(int((r != 0).sum()) for r in plain)}
        print(f"read, not compared: {self.read} (samples of the first steps whose plain reward is not 0); "
              f"rewards of the first steps {[s['reward'] for s in got]}, of the reference's own rollouts "
              f"{[s['reward'] for s in steps]}", file=sys.stderr)
        return numbers


def reward_gap(got: List[torch.Tensor], plain: List[torch.Tensor]) -> float:
    """max over samples of |got - plain| / max(|plain|, the mean |plain|)."""
    got = torch.cat([g.double().cpu().reshape(-1) for g in got])
    plain = torch.cat([p.double().cpu().reshape(-1) for p in plain])
    scale = torch.clamp(plain.abs(), min=max(float(plain.abs().mean()), 1e-30))
    return float(((got - plain).abs() / scale).max())


def print_spans(since_ns: int) -> None:
    """One line on standard error: the count and median ms of each record
    of the program's span ring made since `since_ns` (`device.*`: CUDA
    events inside the step's graph; the rest host spans). A program without
    the ring prints nothing."""
    from swinwnet_tpu_torch.utils import profiling

    if not hasattr(profiling, "spans"):
        return
    by_name: Dict[str, List[float]] = {}
    for r in profiling.spans(since_ns):
        if not r.profiled:
            by_name.setdefault(r.name, []).append((r.end_ns - r.start_ns) * 1e-6)
    print("the window's span records, by name (count, median ms): "
          + json.dumps({k: [len(v), statistics.median(v)] for k, v in sorted(by_name.items())}), file=sys.stderr)


def physics_gap(config: dict, entry, rl) -> float:
    """The port's reward against the plain one on the reference's data.
    Pairs: each rollout against its masked image (`rl.rollouts`), and each
    masked image against the next sample's (both hold Bragg peaks, which a
    rollout of drawn weights may not); each pair as it is and scaled so that
    its second image's largest bin is GATE_SCALE; each on the
    configuration's grid and on one COARSE times coarser. The worst of
    these eight sets' max over pairs of |port - plain| / max(|plain|, the
    set's mean |plain|)."""
    fine = np.linspace(*config["d_centers"])
    coarse = np.linspace(fine[0], fine[-1], (len(fine) - 1) // COARSE + 1)
    worst = 0.0
    for centers in (fine, coarse):
        reward = rl.reward if len(centers) == len(rl.reward.centers) else ref_swinwnet_rl.Reward(centers, rl.lambdas)
        for cross in (False, True):
            for scaled in (False, True):
                port, plain = [], []
                for pred, true in rl.rollouts:
                    if cross:
                        pred, true = true, true.roll(1, dims=0)
                    if scaled:
                        s = (GATE_SCALE / reward.rebin(true).amax(dim=1)).float().reshape(-1, 1, 1, 1)
                        pred, true = pred * s, true * s
                    port.append(entry.physics_reward(config, pred, true, centers))
                    plain.append(reward(pred, true)[0])
                worst = max(worst, reward_gap(port, plain))
    return worst


Loop = RLLoop
