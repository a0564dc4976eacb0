"""One run of one cell: resolve the cell's files by name, set up, measure the
window, trace a slice, compare with the reference, read the metrics.

Everything that belongs to one configuration, traffic mix or metric is a
file of its own, found by the name `BENCHMARK.json` gives it:

    benchmark/configs/<config>.json        the model as run (BENCHMARK.json's `file`)
    benchmark/traffic/<traffic>.json       the mix: entry, loop, batch, pool, checks
    benchmark/entries/<entry>.py           the program's entry point and its control
    benchmark/loops/<loop>.py              how requests or steps are driven
    benchmark/limits/<config>.<entry>.json the comparison's limits, with their readings
    benchmark/metrics/<metric>.json        a per-layer metric's definition
    benchmark/readers/<metric>.py          the reader of any metric: read(run) -> number or None
                                           (or the `reader` its metric file names)
"""

from __future__ import annotations

import dataclasses
import gc
import importlib
import importlib.util
import json
import math
import subprocess
import sys
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

import torch

from .yardstick import compare, reference, weights

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
OUT = BENCH / "out"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "swinwnet_tpu")


def _json(path: Path) -> dict:
    return json.loads(path.read_text())


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    entry: object
    loop: object
    limits: Dict[str, float]
    end_to_end: List[dict]
    per_layer: List[dict]


def load_cell(name: str, spec: Optional[dict] = None) -> Cell:
    spec = spec if spec is not None else _json(ROOT / "BENCHMARK.json")
    work = {w["name"]: w for w in spec["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r}; BENCHMARK.json has {sorted(work)}")
    w = work[name]
    cfg = {c["name"]: c for c in spec["configs"]}[w["config"]]
    traffic = _json(BENCH / "traffic" / f"{w['traffic']}.json")
    e2e = [m for m in spec["end_to_end"] if name in m.get("workloads", [name])]
    e2e_names = {m["name"] for m in e2e}
    per = [m for m in spec["per_layer"] if name in m["workloads"]] + \
          [m for m in spec["per_layer"] if "workloads" not in m and m["moves"] in e2e_names]
    entry = importlib.import_module(f"benchmark.entries.{traffic['entry']}")
    loop = importlib.import_module(f"benchmark.loops.{traffic['loop']}")
    limits = compare.load_limits(BENCH / "limits" / f"{w['config']}.{traffic['entry']}.json")
    return Cell(name, _json(ROOT / cfg["file"]), traffic, entry, loop, limits, e2e, per)


def reader(metric: str) -> Callable:
    """`read(run)` from benchmark/readers/<reader>.py, where the metric's own
    file names a `reader` that several metrics share, else <metric>.py."""
    path = BENCH / "readers" / f"{metric_file(metric).get('reader', metric)}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_reader_{len(metric)}_{abs(hash(metric))}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def metric_file(metric: str) -> dict:
    path = BENCH / "metrics" / f"{metric}.json"
    return _json(path) if path.exists() else {}


@dataclasses.dataclass
class Run:
    """What a reader reads: the cell, the window's host record, the traced
    slice (None in an untraced run), the set-up time, the metric's own file."""

    cell: Cell
    window: dict
    trace: Optional[dict]
    setup_s: float
    metric: dict
    notes: List[str]

    def note(self, line: str) -> None:
        self.notes.append(line)


def forbidden_modules() -> List[str]:
    """Top-level names of loaded modules that the port's runs may not load."""
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def power_limit_w() -> Optional[float]:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits", "-i", "0"],
                             capture_output=True, text=True, check=True, timeout=30).stdout
        return float(out.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def _number(x: float) -> Optional[float]:
    """A finite number as it is, anything else as null (JSON has no NaN)."""
    return x if math.isfinite(x) else None


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device, t_start: float,
             control: bool = False) -> dict:
    """One run: the result line's fields, `checks` last, and `notes` (lines
    for standard error)."""
    device = torch.device(device)
    cuda = device.type == "cuda"
    # set-up: the weights and the traffic from the seed, the program, the warm-up
    start = weights.draw_state_dict(reference.build(cell.config, "meta"), seed, device)
    program = (cell.entry.Control if control else cell.entry.Program)(cell.config, cell.traffic, start, device)
    loop = cell.loop.Loop(cell, program, seed, device)
    loop.warm(start)
    if cuda:
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t_start
    window = loop.window(seconds)
    tr = None
    if trace:
        from . import trace as tracing

        tr = tracing.profile_slice(loop, cell.traffic["trace_calls"], OUT / "trace" / f"{cell.name}.json", device)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    # the comparison, once the program's state is freed
    loop.program = program = None
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    reference.no_tf32()
    numbers = loop.check(start)
    checks = compare.judge(numbers, cell.limits)
    notes: List[str] = []
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        run = Run(cell, window, tr, setup_s, {**metric_file(m["name"]), **m}, notes)
        value = reader(m["name"])(run)
        if value is None:
            notes.append(f"{m['name']}: nothing to read in this run; left out")
            continue
        metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": 1, "memory_peak_bytes": int(peak)}
    if cuda:
        dev["power_limit_w"] = power_limit_w()
    if tr is not None:
        dev.update(busy_s=tr["busy_s"], window_s=tr["window_s"])
    result = {"correct": all(c["ok"] for c in checks.values()) and window["failed"] == 0,
              "attempted": window["calls"], "failed": window["failed"], "metrics": metrics, "device": dev}
    if tr is not None:
        result["breakdown"] = {"device_ops": tr["device_ops"], "idle_gaps": tr["idle_gaps"]}
    result["checks"] = {k: {"value": _number(c["value"]), "limit": _number(c["limit"])} for k, c in checks.items()}
    result["notes"] = notes
    return result

