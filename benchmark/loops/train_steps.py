"""Training steps: one trainer stepping over a device-resident pool of
patterns and peak masks, a batch of consecutive rows a step, alternating
even and odd steps as the trainer's epoch loop does, and reading each
step's loss on the host as that loop does.

Set-up builds the trainer once and drives it through its first
`check_steps` steps on rows that all differ (the comparison follows them),
then `warm_steps` more; the window continues from there with the same
trainer and the same feed.
"""

from __future__ import annotations

import math
import time
from typing import Dict

import torch
from torch.profiler import record_function

from ..yardstick import compare, traffic as traffic_gen


class TrainLoop:
    def __init__(self, cell, program, seed: int, device):
        self.cell, self.program, self.device = cell, program, device
        t = cell.traffic
        self.batch, self.pool = t["batch"], t["pool"]
        if self.pool % self.batch or self.pool < self.batch * t["check_steps"]:
            raise ValueError(f"pool {self.pool} must be a multiple of the batch {self.batch} and hold "
                             f"{t['check_steps']} distinct batches")
        counts, masks = traffic_gen.patterns(traffic_gen.detector(t, cell.config), self.pool, seed, device)
        self.images, self.masks = counts[:, None].contiguous(), masks.contiguous()
        self.k = 0
        self.first: Dict[str, object] = {}

    def _rows(self, k: int):
        i = (k * self.batch) % self.pool
        return self.images[i:i + self.batch], self.masks[i:i + self.batch]

    def _step(self, program=None) -> torch.Tensor:
        program = program or self.program
        with record_function("bench.step"):
            loss = program.step(*self._rows(self.k), even=self.k % 2 == 0)
        self.k += 1
        return loss

    def warm(self, state_dict: Dict[str, torch.Tensor]) -> None:
        """The first steps, read for the comparison, then the warm-up."""
        t = self.cell.traffic
        losses = []
        for j in range(t["check_steps"]):
            losses.append(float(self._step()))
            if j == 0:
                self.first["grad"] = self.program.first_grad_norms()
        self.first["loss"] = losses
        self.first["change"] = self.program.change_norms(state_dict)
        for _ in range(t["warm_steps"]):
            float(self._step())

    def window(self, seconds: float) -> dict:
        failed, steps, even = 0, 0, 0
        start = time.perf_counter()
        while True:
            even += self.k % 2 == 0
            with record_function("bench.read_loss"):
                loss = float(self._step())
            failed += not math.isfinite(loss)
            steps += 1
            if time.perf_counter() - start >= seconds:
                break
        return {"kind": "train", "calls": steps, "failed": failed, "images": self.batch * steps,
                "batch": self.batch, "elapsed_s": time.perf_counter() - start, "even_steps": even,
                "odd_steps": steps - even}

    def traced_slice(self, steps: int) -> int:
        for _ in range(steps):
            float(self._step())
        return steps * self.batch

    def check(self, start: Dict[str, torch.Tensor]) -> Dict[str, float]:
        """The reference follows the first steps on the same rows."""
        t = self.cell.traffic
        reference = self.cell.entry.Reference(self.cell.config, t, start, self.device)
        losses = []
        for k in range(t["check_steps"]):
            images, masks = self._rows(k)
            losses.append(float(reference.step(images, masks, even=k % 2 == 0)))
            if k == 0:
                grad = reference.first_grad_norms()
        change = reference.change_norms(start)
        moving = compare.moving_leaves(grad)
        return {"loss": compare.loss_gap(self.first["loss"], losses),
                "first_grad": compare.leaf_gap(self.first["grad"], grad),
                "change": compare.leaf_gap(self.first["change"], change, moving)}


Loop = TrainLoop
