"""Shared set-up of the benchmark's CPU tests: cells cut to a tiny detector
(40 x 60) at the published widths, run by the harness on the CPU."""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import harness  # noqa: E402

TINY = {"height": 40, "width": 60}
CUTS = {
    "wnet-serve-b64": dict(batch=4, pool=8, check_calls=3, check_rows=2, check_block=4),
    "unet-seg-b64": dict(batch=4, pool=8, check_calls=3, check_rows=2, check_block=4),
    "wnet-serve-b1": dict(pool=8, check_calls=4, check_rows=1),
    "wnet-train-s3-b4": dict(batch=2, pool=8),
}
# The limits hold at each cell's own size. At 40 x 60 and B=2, a bf16 step's
# parameter change already reads 0.04-0.06 against the fp32 reference (over
# a limit of 0.03 set at B=4 on the full detector), so the tiny training
# cell runs the program in fp32, where a sound run reads about 1e-5 and only
# a planted fault fails.
CONFIG_CUTS = {"wnet-train-s3-b4": dict(dtype="float32")}


def tiny_cell(workload: str, **config) -> harness.Cell:
    """The cell as BENCHMARK.json defines it, its detector cut to 40 x 60 and
    its batch and pool to a few patterns; its own limits."""
    cell = harness.load_cell(workload)
    cell.config = {**cell.config, **TINY, **CONFIG_CUTS.get(workload, {}), **config}
    cell.traffic = dict(cell.traffic, **CUTS[workload], detector=dict(TINY))
    cell.end_to_end, cell.per_layer = [], []
    return cell


def run_tiny(cell: harness.Cell, seed: int = 2 ** 31 + 11, control: bool = False) -> dict:
    return harness.run_cell(cell, seed, 0.3, False, "cpu", time.perf_counter(), control=control)


@pytest.fixture
def card():
    """The CUDA device, decided here and not at import; skips without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def spec() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())
