"""The port's benchmark (swinwnet_tpu_torch/recipes/bench.py) where there is
no card: the preflight's JSON line and exit code 3 (the counterpart of
tests/test_bench_preflight.py), the loop sizing and the chaining with stub
steps on CPU tensors, the launch counting, the records' names and kinds
against `bench.py` (read with `ast`, so the JAX bench is not imported), and
each record's plumbing at a tiny size on the CPU (the bench itself measures
only on the card)."""

import ast
import json
import math
import os
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from swinwnet_tpu_torch.models import SwinUNet, SwinWNet
from swinwnet_tpu_torch.ops import swin_block as sb
from swinwnet_tpu_torch.recipes import bench

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
TINY = dict(in_chans=1, error_matrix=True, embed_dim=12, depths=(1, 1, 1, 1), num_heads=(3, 3, 3, 3),
            window_size=5)


def _run_bench(env_extra, args=()):
    env = {**os.environ, **env_extra}
    return subprocess.run([sys.executable, "-m", "swinwnet_tpu_torch.recipes.bench", *args], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)


def _infra_line(proc):
    lines = [line for line in proc.stdout.splitlines() if line.startswith("{")]
    assert len(lines) == 1, proc.stdout
    rec = json.loads(lines[0])
    assert rec["value"] is None and rec["infra_failure"] is True
    return rec


def test_no_card_prints_infra_failure_and_exits_3():
    proc = _run_bench({})
    assert proc.returncode == 3, (proc.returncode, proc.stdout, proc.stderr)
    rec = _infra_line(proc)
    assert "no CUDA device" in rec["error"]
    assert "Traceback" not in proc.stderr


def test_wedged_probe_exits_3_without_teardown():
    """A probe that does not finish within the timeout: the JSON line and rc
    3, with no abort from a teardown under the probe thread."""
    proc = _run_bench({"SWINWNET_BENCH_PREFLIGHT_HANG_S": "60", "SWINWNET_BENCH_PREFLIGHT_TIMEOUT_S": "1"})
    assert proc.returncode == 3, (proc.returncode, proc.stdout, proc.stderr)
    assert "did not complete" in _infra_line(proc)["error"]
    assert "terminate called" not in proc.stderr and "Aborted" not in proc.stderr


def test_main_without_a_card_measures_nothing(monkeypatch, capsys):
    def refuse(*a, **k):
        raise AssertionError("a record was measured without a card")

    for name in ("serving_record", "seg_only_record", "rl_record", "training_record", "loader_record",
                 "mesh_record"):
        monkeypatch.setattr(bench, name, refuse)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exc:
        bench.main([])
    assert exc.value.code == 3
    out = [line for line in capsys.readouterr().out.splitlines() if line.startswith("{")]
    assert len(out) == 1 and json.loads(out[0])["infra_failure"] is True


def test_unknown_config_is_refused_before_the_preflight(monkeypatch):
    monkeypatch.setenv("SWINWNET_BENCH_CONFIGS", "full_b64_bf16,no_such_record")
    monkeypatch.setattr(bench, "preflight", lambda *a: pytest.fail("the preflight ran"))
    with pytest.raises(SystemExit, match="no_such_record"):
        bench.main([])


def _jax_bench_main():
    tree = ast.parse((REPO / "bench.py").read_text())
    return next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "main")


def test_every_record_name_of_bench_py():
    names = {n.value for n in ast.walk(_jax_bench_main()) if isinstance(n, ast.Constant)
             and isinstance(n.value, str) and re.fullmatch(r"(full|seg_only|rl_full|train)_[a-z0-9_]+", n.value)}
    assert len(names) == 12
    assert names == set(bench.RECORD_NAMES)


def test_every_kind_of_bench_py():
    kinds = set()
    for node in ast.walk(_jax_bench_main()):
        if isinstance(node, ast.Dict):
            for k, v in zip(node.keys, node.values):
                if isinstance(k, ast.Constant) and k.value == "kind" and isinstance(v, ast.Constant):
                    kinds.add(v.value)
        if isinstance(node, ast.Tuple):  # train_cfgs: (name, kind, dtype, step, tx)
            vals = [e.value for e in node.elts if isinstance(e, ast.Constant)]
            kinds.update(v for v in vals if isinstance(v, str) and v.startswith("training_"))
    ours = {kind for _, kind, *_ in bench.TRAINING} | {"serving_full_pipeline", "serving_config1_segmentation",
                                                       "serving_config5_rl_pipeline", "training_stage1_loader_fed",
                                                       "serving_full_pipeline_mesh"}
    assert kinds == ours


@pytest.mark.parametrize("per_iter,target,want", [(0.01, 0.1, 10), (0.05, 0.01, 3), (0.004, 0.05, 13)])
def test_steady_iters_sizes_the_loop_from_a_probe(per_iter, target, want):
    calls = []

    def probe(n):
        calls.append(n)
        time.sleep(per_iter * n)

    iters, measured = bench.steady_iters(probe, target)
    assert calls == [2]
    assert measured >= per_iter
    assert 3 <= iters <= want and iters == max(3, math.ceil(target / measured))


def test_chained_step_feeds_each_output_to_the_next_call():
    seen = []

    def fn(x):
        seen.append(x.clone())
        return torch.ones(x.shape[0], 2, 2 * x.shape[2], 2 * x.shape[3])  # a 2x output, cropped to the input

    step = bench.chained(fn)
    x = torch.zeros(2, 2, 250, 480)
    y = step(step(x))
    assert torch.equal(seen[1], step(seen[0])) and torch.allclose(y, torch.full_like(x, 2e-12 * 2 * 2 * 250 * 480))
    uncropped = bench.chained(lambda x: torch.ones(1, 1, 10, 10), crop=False)(torch.zeros(1))
    assert torch.allclose(uncropped, torch.tensor([100e-12]))


def test_time_serving_chains_and_counts_launches():
    """Warm-up, the 2-step probe, then the timed calls, each on the last
    output; launches a call from the wrapper counters."""
    calls = []

    def step(x):
        calls.append(x)
        sb.fused_swin_block_cst.launches += 22
        time.sleep(0.002)
        return x + 1

    ips, iters, dt, launches = bench.time_serving(step, torch.zeros(3), 3, target_s=0.02)
    assert len(calls) == 1 + 2 + iters
    assert [int(c[0]) for c in calls[3:]] == list(range(iters))  # the timed loop starts from x and chains
    assert launches == [22, 0, 0]
    assert ips == pytest.approx(3 * iters / dt)


def test_time_training_ends_on_a_device_scalar_and_counts_launches():
    losses = []

    def step():
        sb.fused_swin_block_cst.launches += 6
        sb.fused_swin_block.launches += 1
        losses.append(torch.tensor(float(len(losses))))
        return losses[-1]

    ips, iters, dt, launches = bench.time_training(step, 4, target_s=0.001)
    assert len(losses) == 1 + 2 + iters and launches == [6, 1, 0]
    assert ips == pytest.approx(4 * iters / dt)
    assert bench.per_iteration([8, 6], 4) == [2, 1.5]


@pytest.fixture
def tiny(monkeypatch):
    """bench's models at a tiny width on the CPU, every level through the
    fused wrappers (their plain versions here)."""
    from swinwnet_tpu_torch.models.layers import BasicLayer

    monkeypatch.setattr(BasicLayer, "min_windows", 1)
    monkeypatch.setattr(bench, "wnet", lambda dtype, fused, device, remat=False: SwinWNet(
        **TINY, attn_chunk=8, fused_blocks=fused, remat=remat, dtype=dtype, device=device,
        generator=torch.Generator().manual_seed(0)))
    monkeypatch.setattr(bench, "unet", lambda device: SwinUNet(
        in_chans=2, **{k: v for k, v in TINY.items() if k not in ("in_chans", "error_matrix")}, fused_blocks=True,
        dtype="bfloat16", device=device, generator=torch.Generator().manual_seed(0)))
    return np.random.default_rng(0)


def test_serving_records_at_a_tiny_size(tiny):
    x = tiny.uniform(0, 1e3, (2, 2, 20, 30)).astype(np.float32)
    rec = bench.serving_record("full_b1_bf16", 1, "bfloat16", True, x[:1], 0.0, "cpu")
    assert rec["kind"] == "serving_full_pipeline" and rec["iters"] == 3 and rec["fused_launches"] == [0, 0, 0]
    assert rec["gflops_per_image"] > 0 and rec["mfu_pct"] > 0 and rec["peak_tflops"] == 989
    assert rec["latency_ms_per_image"] == pytest.approx(1e3 / rec["images_per_sec"])
    assert bench.seg_only_record(x, 0.0, "cpu")["kind"] == "serving_config1_segmentation"
    assert bench.rl_record(x, 0.0, "cpu")["kind"] == "serving_config5_rl_pipeline"


def test_flop_count_does_not_depend_on_the_route(tiny):
    """Counted with every level unfused, whatever the model routes, and the
    routes are put back."""
    from swinwnet_tpu_torch.pipelines.split import inference_stages

    x = torch.from_numpy(tiny.uniform(0, 1e3, (2, 2, 20, 30)).astype(np.float32))
    counts = []
    for fused in (True, False):
        model = bench.wnet("float32", fused, "cpu")
        fn = lambda images: inference_stages(model, images)["images_masked_hr"]
        counts.append(bench.gflops_per_image(model, fn, x))
        assert all(m.fused_blocks == fused for m in model.modules() if hasattr(m, "fused_blocks"))
    assert counts[0] == counts[1] > 0


@pytest.mark.parametrize("name,kind,stage,dtype", bench.TRAINING)
def test_training_records_take_steps_at_a_tiny_size(tiny, name, kind, stage, dtype):
    images = tiny.uniform(0, 1e3, (4, 1, 20, 30)).astype(np.float32)
    masks = (tiny.uniform(size=(4, 20, 30)) > 0.9).astype(np.float32)
    rec = bench.training_record(name, kind, stage, dtype, images, masks, 0.0, "cpu")
    assert rec["name"] == name and rec["iters"] == 3 and rec["batch"] == 4 and rec["remat"] is True


def test_trainer_step_uses_the_stage_mask_at_a_constant_rate(tiny):
    model, step = bench.trainer_step("stage1", "float32", "cpu")
    frozen = {k: p.detach().clone() for k, p in model.named_parameters() if k.startswith("upscaler_")}
    for _ in range(2):
        loss = step(np.ones((4, 1, 20, 30), np.float32), np.zeros((4, 20, 30), np.float32))
    assert torch.isfinite(loss)
    assert all(torch.equal(p, frozen[k]) for k, p in model.named_parameters() if k in frozen)


@pytest.mark.parametrize("name", bench.LOADER_FED)
def test_loader_fed_records_at_a_tiny_size(tiny, name):
    images = tiny.uniform(0, 1e3, (8, 20, 30)).astype(np.float32)
    masks = (tiny.uniform(size=(8, 20, 30)) > 0.9).astype(np.float32)
    rec = bench.loader_record(name, images, masks, 0.0, "cpu")
    assert rec["kind"] == "training_stage1_loader_fed" and rec["iters"] == 3


def test_a_loop_that_goes_non_finite_raises():
    with pytest.raises(FloatingPointError, match="serving output"):
        bench.time_serving(lambda x: x * float("inf"), torch.ones(2), 2, target_s=0.0)
    with pytest.raises(FloatingPointError, match="loss"):
        bench.time_training(lambda: torch.tensor(float("nan")), 4, target_s=0.0)
