"""Readings for the comparison's limits, on the card, at a cell's own size:
the program's numbers and the control's (the reference with float8
products in the program's place) over several seeds in one process.

    python3 benchmark/control.py --workload <name> --seeds 1,2,3 [--program-seeds 4,5,...] [--seconds 2]

Prints one JSON line a run, {"seed", "side", "checks"}, and a summary:
each number's largest program reading and smallest control reading.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def _seeds(text: str):
    return [int(s) for s in text.split(",") if s]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="", help="seeds the control runs on")
    p.add_argument("--program-seeds", default="", help="seeds the program runs on")
    p.add_argument("--seconds", type=float, default=2.0)
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from benchmark import harness

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 3
    cell = harness.load_cell(args.workload)
    cell.end_to_end = []
    worst = {"program": {}, "control": {}}
    for side, seeds in (("program", _seeds(args.program_seeds)), ("control", _seeds(args.seeds))):
        for seed in seeds:
            t0 = time.perf_counter()
            r = harness.run_cell(cell, seed, args.seconds, False, "cuda", t0, control=side == "control")
            checks = {k: c["value"] for k, c in r["checks"].items()}
            print(json.dumps({"workload": args.workload, "seed": seed, "side": side, "checks": checks,
                              "attempted": r["attempted"], "seconds": time.perf_counter() - t0}), flush=True)
            pick = max if side == "program" else min
            for k, v in checks.items():
                worst[side][k] = pick(worst[side].get(k, v), v)
            torch.cuda.empty_cache()
    print(json.dumps({"workload": args.workload, "program_max": worst["program"], "control_min": worst["control"],
                      "card": torch.cuda.get_device_name(0), "power_limit_w": harness.power_limit_w()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
