"""Readings for the limits of the REINFORCE cell (`wnet-rl-step-b4`) on the
card: the comparison's numbers of sound runs, of the float8 control and of
each fault that `benchmark/tests/test_port_benchmark_rl.py` plants in the
timed path, each on its own seeds, in one process.

    python3 scripts/rl_cell_readings.py --program-seeds 1,2 [--control-seeds 3] \\
        [--fault-seeds 4 | --fault-seeds auto:3] [--faults half_batch,noise_dropped] [--seconds 2]

`--fault-seeds auto:N` takes the first N program seeds whose first steps
rewarded a sample (a reward that is not 0: where every reward is 0, the
policy's gradient is 0 and a policy fault changes nothing). Prints one JSON
line a run ({"side", "seed", "checks", what was read beside them, the first
steps of the program and of the reference, ...}) and a summary: each
number's largest sound reading and smallest control reading, and each
fault's readings.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
WORKLOAD = "wnet-rl-step-b4"


def _seeds(text: str):
    return [int(s) for s in text.split(",") if s]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--program-seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--fault-seeds", default="")
    p.add_argument("--faults", default="", help="comma-separated; all of them by default")
    p.add_argument("--seconds", type=float, default=2.0)
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import pytest
    import torch

    from benchmark import harness
    from benchmark.loops import rl_steps
    from benchmark.tests.test_port_benchmark_rl import FAULTS

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 3
    faults = [f for f in args.faults.split(",") if f] or sorted(FAULTS)
    runs = [("program", None, s) for s in _seeds(args.program_seeds)]
    runs += [("control", None, s) for s in _seeds(args.control_seeds)]
    auto = int(args.fault_seeds[len("auto:"):]) if args.fault_seeds.startswith("auto:") else None
    if auto is None:
        runs += [("fault", f, s) for f in faults for s in _seeds(args.fault_seeds)]
    rewarded: list = []
    loops = []

    class Loop(rl_steps.RLLoop):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            loops.append(self)

    summary = {"program_max": {}, "control_min": {}, "faults": {}, "rewarded_seeds": rewarded}
    i = 0
    while i < len(runs):
        side, fault, seed = runs[i]
        i += 1
        cell = harness.load_cell(WORKLOAD)
        cell.end_to_end = []
        cell.loop = type("Loops", (), {"Loop": Loop})
        t0 = time.perf_counter()
        with pytest.MonkeyPatch.context() as mp:
            if fault:
                FAULTS[fault](mp)
            r = harness.run_cell(cell, seed, args.seconds, False, "cuda", t0, control=side == "control")
        loop = loops[-1]
        checks = {k: c["value"] for k, c in r["checks"].items()}
        checks.update(loop.read)
        print(json.dumps({"side": side, "fault": fault, "seed": seed, "correct": r["correct"], "checks": checks,
                          "program_steps": loop.first["steps"], "reference_steps": loop.reference_steps,
                          "attempted": r["attempted"], "seconds": time.perf_counter() - t0}), flush=True)
        if side == "program" and loop.read["rewarded"]:
            rewarded.append(seed)
        if auto is not None and i == len(runs):
            runs += [("fault", f, s) for f in faults for s in rewarded[:auto]]
            auto = None
        if side == "fault":
            summary["faults"].setdefault(fault, []).append(checks)
        else:
            worst, pick = summary[f"{side}_{'max' if side == 'program' else 'min'}"], max if side == "program" else min
            for k, v in checks.items():
                worst[k] = pick(worst.get(k, v), v)
        loops.clear()
        torch.cuda.empty_cache()
    summary.update(card=torch.cuda.get_device_name(0), power_limit_w=harness.power_limit_w())
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
