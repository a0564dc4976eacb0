"""Closed-loop serving: one caller sends a batch of host arrays, waits for
the answer on the host, and sends the next.

The window runs calls until `seconds` have passed; the last call started
runs to its end, and the window is the time from the first call's start to
the last call's answer on the host. Each call records three host times:
its start, the return of the entry's call (the host's span: the input copy,
the program's key and the replay's launch) and the answer on the host.

A sample of the window's calls is kept for the comparison with the
reference: a reservoir of `check_calls` calls drawn from the seed, with
`check_rows` rows of each, copied after the call's answer is timed.
"""

from __future__ import annotations

import random
import time
from typing import Dict, List

import numpy as np
import torch
from torch.profiler import record_function

from ..yardstick import compare, reference, traffic as traffic_gen
from ..yardstick.weights import SAMPLE, sub_seed


class ServeLoop:
    def __init__(self, cell, program, seed: int, device):
        self.cell, self.program, self.device = cell, program, device
        t = cell.traffic
        entry = cell.entry
        self.batch = t["batch"]
        pool = t["pool"]
        if pool % self.batch:
            raise ValueError(f"pool {pool} is not a multiple of the batch {self.batch}")
        counts, _ = traffic_gen.patterns(traffic_gen.detector(t, cell.config), pool, seed, device)
        perm = torch.randperm(pool, generator=torch.Generator().manual_seed(sub_seed(seed, SAMPLE)))
        counts = counts[perm.to(counts.device)]
        shape = entry.request_shape(cell.config, pool)
        x = traffic_gen.error_channel(counts) if shape[1] == 2 else counts[:, None]
        self.pool = x.cpu().numpy()  # the users' host arrays
        self.batches = [self.pool[i:i + self.batch] for i in range(0, pool, self.batch)]
        self.answer_name = entry.ANSWER
        self.host_out = None
        self.rng = random.Random(sub_seed(seed, SAMPLE))
        self.check_calls, self.check_rows = t["check_calls"], t["check_rows"]
        self.sample: List[dict] = []
        self.offered = 0

    # -- one request ---------------------------------------------------------

    def _call(self, k: int):
        x = self.batches[k % len(self.batches)]
        t0 = time.perf_counter()
        with record_function("bench.call"):
            outs = self.program(x)
        t1 = time.perf_counter()
        with record_function("bench.fetch"):
            answer = outs[self.answer_name]
            if self.host_out is None or self.host_out.shape != answer.shape:
                self.host_out = torch.empty(answer.shape, dtype=answer.dtype)
            self.host_out.copy_(answer)
        t2 = time.perf_counter()
        return x, outs, (t0, t1, t2)

    def _offer(self, k: int, x: np.ndarray, outs: Dict[str, torch.Tensor]) -> None:
        """Reservoir sampling over the window's calls."""
        self.offered += 1
        if len(self.sample) < self.check_calls:
            slot = len(self.sample)
            self.sample.append(None)
        else:
            slot = self.rng.randrange(self.offered)
            if slot >= self.check_calls:
                return
        rows = sorted(self.rng.sample(range(len(x)), min(self.check_rows, len(x))))
        idx = torch.tensor(rows)
        kept = {name: t.index_select(0, idx.to(t.device)).cpu() for name, t in outs.items() if name != self.answer_name}
        kept[self.answer_name] = self.host_out.index_select(0, idx)
        self.sample[slot] = {"call": k, "rows": rows, "x": torch.from_numpy(x[rows].copy()), "outputs": kept}

    # -- phases --------------------------------------------------------------

    def warm(self, start=None, calls: int = 2) -> None:
        for k in range(calls):
            self._call(k)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def window(self, seconds: float) -> dict:
        spans, failed = [], 0
        start = time.perf_counter()
        k = 0
        while True:
            try:
                x, outs, times = self._call(k)
            except RuntimeError:
                failed += 1
                times = None
            if times is not None:
                spans.append(times)
                self._offer(k, x, outs)
                del outs
            k += 1
            if time.perf_counter() - start >= seconds:
                break
        end = spans[-1][2] if spans else time.perf_counter()
        return {"kind": "serve", "calls": k, "failed": failed, "images": self.batch * (k - failed),
                "batch": self.batch, "elapsed_s": end - start,
                "latency_s": [t2 - t0 for t0, _, t2 in spans], "host_s": [t1 - t0 for t0, t1, _ in spans]}

    def traced_slice(self, calls: int) -> int:
        """`calls` more calls, as in the window: the caller profiles them."""
        for k in range(calls):
            self._call(k)
        return calls * self.batch

    # -- the comparison ------------------------------------------------------

    def check(self, start: Dict[str, torch.Tensor]) -> Dict[str, float]:
        """Each output's RMS gap to the reference over the sampled rows, as a
        share of the reference's spread, a block of rows at a time."""
        entry, block = self.cell.entry, self.cell.traffic["check_block"]
        ref_model = reference.build(self.cell.config, self.device)
        ref_model.load_state_dict(start)
        acc = {name: compare.RelRMS() for name in entry.OUTPUTS}
        rows = [(s["x"][i], {n: t[i] for n, t in s["outputs"].items()}) for s in self.sample
                for i in range(len(s["rows"]))]
        for i in range(0, len(rows), block):
            part = rows[i:i + block]
            x = torch.stack([r[0] for r in part]).to(self.device)
            ref = entry.reference_outputs(ref_model, x)
            for name in entry.OUTPUTS:
                acc[name].add(torch.stack([r[1][name] for r in part]).to(self.device), ref[name])
        return {name: a.value() for name, a in acc.items()}


Loop = ServeLoop
