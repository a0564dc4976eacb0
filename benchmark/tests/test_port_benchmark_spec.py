"""BENCHMARK.json against the form it must keep, every name it gives resolved
to its files, and the command's refusals without a card."""

from __future__ import annotations

import json
import re
import shutil
import subprocess
import sys

import pytest

from benchmark import harness
from benchmark.tests.conftest import ROOT, spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"},
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source", "workloads"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves", "workloads"},
}


def test_keys_names_and_units():
    s = spec()
    assert set(s) == KEYS["top"]
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in s[group]]
        assert len(names) == len(set(names)), group
        for e in s[group]:
            assert set(e) <= KEYS[group], (group, e["name"])
            assert NAME.match(e["name"]), e["name"]
            if "unit" in e:
                assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher"), e["name"]
    for w in s["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"]) and w["chips"] == 1
        assert len(w["why"]) <= 200 and "\n" not in w["why"] and "\t" not in w["why"]
    for c in s["configs"]:
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["source"]) <= 200
    for m in s["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in s["end_to_end"])
    assert len(json.dumps(s)) < 64 * 1024 and 1 <= s["run_seconds"] <= 51


def test_every_name_resolves_to_its_files():
    """A cell, a configuration, a traffic mix and a metric are files found by
    name: every cell loads, every metric has a reader, and each per-layer
    metric's own file agrees with BENCHMARK.json."""
    s = spec()
    for w in s["workloads"]:
        cell = harness.load_cell(w["name"], s)
        assert cell.limits and cell.end_to_end and cell.per_layer
        assert any(m["name"] == "setup_s" for m in cell.end_to_end)
        assert cell.config["reduced"] == next(c for c in s["configs"] if c["name"] == w["config"])["reduced"]
    e2e = {m["name"] for m in s["end_to_end"]}
    for m in s["end_to_end"] + s["per_layer"]:
        assert callable(harness.reader(m["name"])), m["name"]
    for m in s["per_layer"]:
        own = harness.metric_file(m["name"])
        assert {k: own[k] for k in m} == m, m["name"]
        assert m["moves"] in e2e
        for w in m["workloads"]:
            cell = harness.load_cell(w, s)
            assert m["moves"] in {x["name"] for x in cell.end_to_end}


def _run(cwd, *extra):
    cmd = [sys.executable, "benchmark/run.py", "--workload", "wnet-serve-b1", "--seed", str(2 ** 31 + 5),
           "--seconds", "1", "--trace", "0", *extra]
    return subprocess.run(cmd, capture_output=True, text=True, cwd=cwd, timeout=300)


def test_without_a_card_the_command_fails_and_prints_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = _run(ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "no CUDA device" in out.stderr


def test_without_the_program_the_command_fails(tmp_path):
    """In a directory that holds only BENCHMARK.json and the benchmark's files."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark", ignore=shutil.ignore_patterns("out", "__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.cuda
def test_a_cell_runs_correct_on_the_card(card):
    """One short run of the viewer's cell on the card, as the command runs it."""
    out = _run(ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and list(result)[-1] == "checks", result
    assert result["device"]["platform"] == "gpu" and result["device"]["count"] == 1
