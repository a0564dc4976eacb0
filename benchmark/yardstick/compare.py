"""The comparison that decides `correct`: the numbers compared with the
reference, each against a limit of its own.

Serving: for each output, the RMS of (program - reference) over the sampled
images, as a share of the reference's standard deviation over them.
Training: the worst relative gap of the first steps' losses; and by the
worst leaf, the gap between the program's and the reference's norms of the
first gradient and of the parameters' change over the first steps, as a
share of the reference's norm of that leaf or of the median leaf, whichever
is larger.
"""

from __future__ import annotations

import json
import math
import statistics
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import torch


class RelRMS:
    """Accumulates sum((p - r)^2), sum(r), sum(r^2) over blocks of images in
    float64; `value()` is rms(p - r) / std(r)."""

    def __init__(self):
        self.sq = self.s1 = self.s2 = 0.0
        self.n = 0

    def add(self, program: torch.Tensor, ref: torch.Tensor) -> None:
        p, r = program.double(), ref.double().to(program.device)
        self.sq += float(((p - r) ** 2).sum())
        self.s1 += float(r.sum())
        self.s2 += float((r ** 2).sum())
        self.n += r.numel()

    def value(self) -> float:
        if self.n == 0:
            return math.nan
        mean = self.s1 / self.n
        var = max(self.s2 / self.n - mean * mean, 0.0)
        return math.sqrt(self.sq / self.n) / max(math.sqrt(var), 1e-30)


def loss_gap(program: Sequence[float], ref: Sequence[float]) -> float:
    """max over steps of |program - reference| / |reference|."""
    return max(abs(p - r) / max(abs(r), 1e-30) for p, r in zip(program, ref))


def leaf_gap(program: Dict[str, float], ref: Dict[str, float], leaves: Optional[List[str]] = None) -> float:
    """max over `leaves` (all by default) of |program norm - reference norm|
    / max(reference norm of the leaf, the median leaf's)."""
    leaves = list(ref) if leaves is None else leaves
    med = statistics.median(ref[k] for k in leaves)
    return max(abs(program[k] - ref[k]) / max(ref[k], med, 1e-30) for k in leaves)


def moving_leaves(ref_grad: Dict[str, float], share: float = 1e-3) -> List[str]:
    """The leaves whose reference gradient is at least `share` of the median
    leaf's: the rest (a key's bias under softmax) move under Adam by
    rounding alone."""
    med = statistics.median(ref_grad.values())
    return [k for k, v in ref_grad.items() if v >= share * med]


def load_limits(path: Path) -> Dict[str, float]:
    """{number: limit} from a limits file ({"limits": {...}, ...})."""
    return {k: float(v) for k, v in json.loads(path.read_text())["limits"].items()}


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> Dict[str, dict]:
    """Each number beside its limit; a number with no limit or not finite fails."""
    out = {}
    for name, value in numbers.items():
        limit = limits.get(name, math.nan)
        ok = math.isfinite(value) and math.isfinite(limit) and value <= limit
        out[name] = {"value": value, "limit": limit, "ok": ok}
    return out
