"""Runs one cell of the port's benchmark once on the CUDA card it finds.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. It sets up (weights and traffic drawn from the
seed, the program built and warmed up), measures for `--seconds`, compares
what the window produced with the plain reference, and prints one JSON
line last on standard output: `correct`, `attempted`, `failed`, `metrics`
(the cell's end-to-end metrics, or with `--trace 1` its per-layer ones),
`device`, with `--trace 1` a `breakdown`, and `checks` (each number
compared, beside its limit) last. The same numbers close standard error.

Without a CUDA card, with fewer cards than the cell asks for, or with JAX
or the JAX package loaded once the window has closed, it prints no result
and exits with a code other than 0. Build and kernel caches stay under
`benchmark/out/` in the checkout.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def _caches() -> None:
    """Fixed cache directories inside the checkout, so that only a cell's
    first run there builds and compiles."""
    cache = ROOT / "benchmark" / "out" / "cache"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(cache / sub)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    _caches()
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    import torch

    from benchmark import harness

    cell_spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    chips = {w["name"]: w["chips"] for w in cell_spec["workloads"]}.get(args.workload)
    if chips is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("no CUDA device: torch.cuda.is_available() is False; nothing is measured on the CPU", file=sys.stderr)
        return 3
    if torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} cards, {torch.cuda.device_count()} found", file=sys.stderr)
        return 3
    cell = harness.load_cell(args.workload, cell_spec)
    result = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", T_START)
    loaded = harness.forbidden_modules()
    if loaded:
        print(f"modules the port's runs may not load were loaded: {loaded}", file=sys.stderr)
        return 4
    notes = result.pop("notes")
    for line in notes:
        print(line, file=sys.stderr)
    d = result["device"]
    print(f"card: {d['kind']}, power limit {d.get('power_limit_w')} W; seed {args.seed}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(f"correct: {result['correct']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
