"""Throughput benchmark of the port on the card: serving and training
records, each printed as it is measured, then one summary line (port of
`bench.py`).

    python -m swinwnet_tpu_torch.recipes.bench [--mesh]

The headline is the flagship multimodal pipeline ([B, 2, 250, 480]
diffraction + error matrix -> masked 2x-SR pattern) at B=64 in bf16 through
the fused Swin-block kernel. The records, with `bench.py`'s names, kinds,
batch sizes, dtypes and routes:

* full_b64_bf16       headline serving throughput (images/s a card)
* full_b1_bf16        single-image serving latency (ms an image)
* full_b8_fp32        fp32, fused blocks off
* seg_only_b64_bf16   SwinUNet through `make_segmentation_fn`
* rl_full_b64_bf16    the RL alpha-policy pipeline (`RLInference`'s stages)
* train_stage1_b4, train_stage3_odd_b4 and their _bf16 variants: one step
  (forward, backward, the stage's masked AdamW) with fp32 parameters,
  remat, fused blocks off; _bf16 computes in bf16
* train_stage1_b4_loader_py / _loader_native: stage 1 fed a fresh batch a
  step by `ArrayLoader` (numpy noise inline) or by the C++ `NativeBatcher`
  over 64 source patterns
* full_b64_bf16_mesh  (`--mesh` or SWINWNET_BENCH_MESH=1) the headline over
  every card, one rank a card through `parallel`, batch 64 a card

Each record is a loop sized from a 2-iteration probe to
SWINWNET_BENCH_TARGET_S seconds of steady state (30 by default);
SWINWNET_BENCH_CONFIGS (comma-separated names) picks records. Serving calls
are chained, each call's input mixing in the previous output, training
steps chain through the parameters the optimizer updates, and each timed
loop ends by fetching one device scalar to the host. A record also carries
its peak device memory, the card's name and power limit, the fused-kernel
launches a call or step (the wrapper counters: cst, row-major, wide), and
for serving the operations an image needs (`FlopCounterMode` over one B=1
call with every level unfused, so the count does not depend on what
computes a block) with the share of the card's peak that makes.

Before anything is measured a preflight checks for a CUDA device and a
trivial product on it; without them it prints one JSON line with
`infra_failure: true` and exits with 3. Nothing is measured on the CPU.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import subprocess
import sys
import tempfile
import threading
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

METRIC = "swinwnet_full_inference_throughput"
UNIT = "images/sec/card"
H, W = 250, 480
# the H100 SXM's published dense peaks: bf16 on the tensor cores, and fp32
# outside them (the figure every fp32 bound in this repository uses)
PEAK_FLOPS = {"bfloat16": (989e12, "H100 SXM dense bf16"), "float32": (67e12, "H100 SXM fp32, no tensor cores")}
PUBLISHED = dict(in_chans=1, error_matrix=True, embed_dim=48, depths=(2, 2, 2, 2), num_heads=(3, 6, 12, 24),
                 window_size=5)
# (name, batch, dtype, fused blocks), bench.py's serving records
SERVING = [
    ("full_b64_bf16", 64, "bfloat16", True),
    ("full_b1_bf16", 1, "bfloat16", True),
    ("full_b8_fp32", 8, "float32", False),
]
TRAIN_B = 4
# (name, kind, stage, compute dtype)
TRAINING = [
    ("train_stage1_b4", "training_stage1_step", "stage1", "float32"),
    ("train_stage1_b4_bf16", "training_stage1_step", "stage1", "bfloat16"),
    ("train_stage3_odd_b4", "training_stage3_odd_step", "stage3", "float32"),
    ("train_stage3_odd_b4_bf16", "training_stage3_odd_step", "stage3", "bfloat16"),
]
LOADER_FED = ("train_stage1_b4_loader_py", "train_stage1_b4_loader_native")
N_SRC = 64  # the loader-fed records' source patterns; a multiple of the batch
RECORD_NAMES = ([n for n, *_ in SERVING] + ["seg_only_b64_bf16", "rl_full_b64_bf16"]
                + [n for n, *_ in TRAINING] + list(LOADER_FED) + ["full_b64_bf16_mesh"])


# ---------------------------------------------------------------------------
# Preflight
# ---------------------------------------------------------------------------


def preflight(timeout_s: Optional[float] = None) -> None:
    """Returns when a CUDA device answers a trivial product within
    `timeout_s` (SWINWNET_BENCH_PREFLIGHT_TIMEOUT_S, 240 by default); else
    prints one JSON line (`value: null`, `infra_failure: true`, the reason)
    and exits with 3. SWINWNET_BENCH_PREFLIGHT_HANG_S delays the probe, to
    test the timeout without a card."""
    if timeout_s is None:
        timeout_s = float(os.environ.get("SWINWNET_BENCH_PREFLIGHT_TIMEOUT_S", "240"))
    hang_s = float(os.environ.get("SWINWNET_BENCH_PREFLIGHT_HANG_S", "0") or 0)
    result = {}

    def probe():
        try:
            if hang_s:
                time.sleep(hang_s)
            if not torch.cuda.is_available():
                result["error"] = "no CUDA device: torch.cuda.is_available() is False"
                return
            x = torch.ones(128, 128, device="cuda")
            result["ok"] = float((x @ x).sum()) == 128.0 ** 3
            if not result["ok"]:
                result["error"] = "a trivial product on the card gave a wrong sum"
        except Exception as e:  # noqa: BLE001 -- reported in the JSON line, not raised in the thread
            result["error"] = f"{type(e).__name__}: {e}"

    th = threading.Thread(target=probe, daemon=True)
    th.start()
    th.join(timeout_s)
    if result.get("ok"):
        return
    print(json.dumps({
        "metric": METRIC, "value": None, "unit": UNIT, "infra_failure": True,
        "error": result.get("error", f"device unreachable: a trivial product did not complete in {timeout_s:.0f}s"),
        "platform": "cuda",
    }), flush=True)
    if th.is_alive():
        # the probe may be wedged inside a CUDA call: leave without the
        # interpreter's teardown running underneath it
        sys.stderr.flush()
        os._exit(3)
    sys.exit(3)


# ---------------------------------------------------------------------------
# Loops
# ---------------------------------------------------------------------------


def steady_iters(probe_fn: Callable[[int], None], target_s: float):
    """Run a 2-iteration probe and size the timed loop to >= target_s:
    (iterations, seconds an iteration in the probe)."""
    t0 = time.perf_counter()
    probe_fn(2)
    per_iter = (time.perf_counter() - t0) / 2
    return max(3, math.ceil(target_s / max(per_iter, 1e-9))), per_iter


def chained(fn: Callable[[torch.Tensor], torch.Tensor], crop: bool = True) -> Callable[[torch.Tensor], torch.Tensor]:
    """A serving step whose output is its next input: x + 1e-12 * the sum of
    the call's output (cropped to the input's 250x480 when `crop`), so each
    call depends on the one before it."""

    def step(x):
        out = fn(x)
        if crop:
            out = out[:, :, :H, :W]
        return x + 1e-12 * out.sum().float()

    return step


def launch_counts() -> List[int]:
    from ..ops import swin_block as sb

    return [k.launches for k in sb.KERNELS]


def per_iteration(counts: List[int], iters: int) -> List:
    """Launches an iteration (an int where the count divides evenly)."""
    return [c // iters if c % iters == 0 else c / iters for c in counts]


def finite(value: float, what: str) -> float:
    if not math.isfinite(value):
        raise FloatingPointError(f"{what} is not finite: {value}")
    return value


def time_serving(step, x, batch: int, target_s: float):
    """The chained serving loop: (images/s, iterations, seconds, fused
    launches a call). Raises if the chained output is not finite."""
    float(step(x).sum())  # warm-up: cuDNN, the allocator, the kernels' library

    def run(n):
        y = x
        for _ in range(n):
            y = step(y)
        return float(y.sum())  # the completion barrier: one device scalar to the host

    iters, _ = steady_iters(run, target_s)
    before = launch_counts()
    t0 = time.perf_counter()
    last = run(iters)
    dt = time.perf_counter() - t0
    finite(last, "the chained serving output")
    counts = [b - a for a, b in zip(before, launch_counts())]
    return batch * iters / dt, iters, dt, per_iteration(counts, iters)


def time_training(step: Callable[[], torch.Tensor], batch: int, target_s: float):
    """The training loop: `step()` takes one optimizer step on the model in
    place and returns its loss on the device. (images/s, iterations,
    seconds, fused launches a step). Raises if the last loss is not finite."""
    float(step())  # warm-up

    def run(n):
        loss = None
        for _ in range(n):
            loss = step()
        return float(loss)  # waits for the last update, queued before the copy

    iters, _ = steady_iters(run, target_s)
    before = launch_counts()
    t0 = time.perf_counter()
    last = run(iters)
    dt = time.perf_counter() - t0
    finite(last, "the last step's loss")
    counts = [b - a for a, b in zip(before, launch_counts())]
    return batch * iters / dt, iters, dt, per_iteration(counts, iters)


@contextlib.contextmanager
def unfused(model: torch.nn.Module):
    """Every level of `model` on the unfused blocks for the block."""
    from ..models.layers import BasicLayer

    levels = [m for m in model.modules() if isinstance(m, BasicLayer)]
    saved = [m.fused_blocks for m in levels]
    for m in levels:
        m.fused_blocks = False
    try:
        yield
    finally:
        for m, f in zip(levels, saved):
            m.fused_blocks = f


def gflops_per_image(model: torch.nn.Module, fn: Callable, x: torch.Tensor) -> float:
    """The operations of one B=1 call of `fn`, every level unfused, counted
    by `FlopCounterMode` (products and convolutions), in GFLOP."""
    from torch.utils.flop_counter import FlopCounterMode

    with unfused(model), FlopCounterMode(display=False) as counter:
        fn(x[:1])
    return counter.get_total_flops() / 1e9


# ---------------------------------------------------------------------------
# Records
# ---------------------------------------------------------------------------


def wnet(dtype: str, fused_blocks: bool, device, remat: bool = False):
    """bench.py's SwinWNet: the published width, attn_chunk 8192, weights
    drawn from a generator seeded with 0."""
    from ..models import SwinWNet

    return SwinWNet(**PUBLISHED, attn_chunk=8192, fused_blocks=fused_blocks, remat=remat, dtype=dtype,
                    device=device, generator=torch.Generator().manual_seed(0))


def serving_record(name, batch, dtype, fused_blocks, x, target_s, device):
    from ..pipelines.split import inference_stages

    model = wnet(dtype, fused_blocks, device).eval()
    fn = lambda images: inference_stages(model, images)["images_masked_hr"]
    xd = torch.from_numpy(x).to(device)
    gflops = gflops_per_image(model, fn, xd)
    ips, iters, dt, launches = time_serving(chained(fn), xd, batch, target_s)
    peak, source = PEAK_FLOPS[dtype]
    rec = {"name": name, "kind": "serving_full_pipeline", "batch": batch, "dtype": dtype,
           "fused_blocks": fused_blocks, "images_per_sec": ips, "iters": iters, "steady_state_s": dt,
           "fused_launches": launches, "gflops_per_image": gflops,
           "mfu_pct": 100.0 * gflops * 1e9 * ips / peak, "peak_tflops": peak / 1e12, "peak_of": source}
    if batch == 1:
        rec["latency_ms_per_image"] = 1e3 / ips
    return rec


def unet(device):
    """bench.py's SwinUNet: two input channels, the published width, attn_chunk
    8192, bf16, fused blocks, weights drawn from a generator seeded with 0."""
    from ..models import SwinUNet

    return SwinUNet(in_chans=2, embed_dim=48, depths=(2, 2, 2, 2), num_heads=(3, 6, 12, 24), window_size=5,
                    attn_chunk=8192, fused_blocks=True, dtype="bfloat16", device=device,
                    generator=torch.Generator().manual_seed(0))


def seg_only_record(x, target_s, device):
    from ..pipelines.simple import make_segmentation_fn

    fn = make_segmentation_fn(unet(device))
    ips, iters, dt, launches = time_serving(chained(fn, crop=False), torch.from_numpy(x).to(device), len(x),
                                            target_s)
    return {"name": "seg_only_b64_bf16", "kind": "serving_config1_segmentation", "batch": len(x),
            "dtype": "bfloat16", "fused_blocks": True, "images_per_sec": ips, "iters": iters,
            "steady_state_s": dt, "fused_launches": launches}


def rl_record(x, target_s, device):
    from ..models import AlphaPolicy
    from ..pipelines.rl_inference import rl_inference_stages

    model = wnet("bfloat16", True, device).eval()
    policy = AlphaPolicy(device=device, generator=torch.Generator().manual_seed(1)).eval()
    fn = lambda images: rl_inference_stages(model, policy, images)["images_masked_hr"]
    ips, iters, dt, launches = time_serving(chained(fn), torch.from_numpy(x).to(device), len(x), target_s)
    return {"name": "rl_full_b64_bf16", "kind": "serving_config5_rl_pipeline", "batch": len(x),
            "dtype": "bfloat16", "fused_blocks": True, "images_per_sec": ips, "iters": iters,
            "steady_state_s": dt, "fused_launches": launches}


def trainer_step(stage: str, dtype: str, device):
    """(model, `step(images, masks) -> loss`): one step of `stage` ("stage1"
    or "stage3", odd) through the port's trainer on bench.py's training
    model, with the stage's masked AdamW at a constant 1e-4 as bench.py
    builds it."""
    from ..train import FullModelTrainer, SegmentatorTrainer
    from ..train.freeze import masked_adamw

    model = wnet("float32", False, device, remat=True).train()
    if stage == "stage1":
        trainer = SegmentatorTrainer(model, [None], compute_dtype=dtype, verbose=False)
        step = trainer.train_step
    else:
        trainer = FullModelTrainer(model, [None], compute_dtype=dtype, verbose=False)
        step = lambda images, masks: trainer.train_step(images, masks, even=False)["loss"]
    trainer.optimizer = masked_adamw(model, trainer.stage, 1e-4)
    return model, step


def training_record(name, kind, stage, dtype, images, masks, target_s, device):
    _, step = trainer_step(stage, dtype, device)
    images, masks = torch.from_numpy(images).to(device), torch.from_numpy(masks).to(device)
    ips, iters, dt, launches = time_training(lambda: step(images, masks), len(images), target_s)
    return {"name": name, "kind": kind, "batch": len(images), "dtype": dtype, "remat": True,
            "images_per_sec": ips, "iters": iters, "steady_state_s": dt, "fused_launches": launches}


def loader_record(name, images_np, masks_np, target_s, device):
    """Stage 1 fed a fresh batch a step from an endless stream of the
    loader's epochs."""
    from ..data import ArrayLoader, NativeBatcher
    from ..data.noise import make_train_noise_augment

    _, step = trainer_step("stage1", "float32", device)
    if name.endswith("_py"):
        loader = ArrayLoader(images_np, masks_np, batch_size=TRAIN_B, shuffle=True,
                             augment=make_train_noise_augment())
        close = lambda: None
    else:
        loader = NativeBatcher(images_np, masks_np, batch_size=TRAIN_B, shuffle=True, add_noise=True)
        close = loader.close

    def stream():
        while True:
            yield from loader

    it = stream()
    try:
        ips, iters, dt, launches = time_training(lambda: step(*next(it)), TRAIN_B, target_s)
    finally:
        close()
    return {"name": name, "kind": "training_stage1_loader_fed", "batch": TRAIN_B, "dtype": "float32",
            "remat": True, "images_per_sec": ips, "iters": iters, "steady_state_s": dt, "fused_launches": launches}


def _mesh_rank(rank: int, n: int, port: int, target_s: float, out_path: str) -> None:
    """One rank of full_b64_bf16_mesh: its 64 images of the global batch on
    its card; rank 0 writes the record."""
    import torch.distributed as dist

    from ..parallel import initialize_multihost, make_mesh, replicate, shard_batch
    from ..parallel.sharding import mesh_device
    from ..pipelines.split import inference_stages

    initialize_multihost(f"localhost:{port}", n, rank, device="cuda")
    try:
        mesh = make_mesh(n)
        dev = mesh_device(mesh)
        model = replicate(wnet("bfloat16", True, dev), mesh).eval()
        x = shard_batch(np.random.default_rng(0).uniform(0, 1e3, (64 * n, 2, H, W)).astype(np.float32), mesh)
        step = chained(lambda images: inference_stages(model, images)["images_masked_hr"])
        float(step(x).sum())  # warm-up

        def run(k):
            y = x
            for _ in range(k):
                y = step(y)
            return float(y.sum())

        iters, _ = steady_iters(run, target_s)
        iters_t = torch.tensor(iters, device=dev)
        dist.all_reduce(iters_t, op=dist.ReduceOp.MAX, group=mesh.get_group())  # every rank runs as many
        iters = int(iters_t)
        torch.cuda.reset_peak_memory_stats(dev)
        dist.barrier(group=mesh.get_group())
        before = launch_counts()
        t0 = time.perf_counter()
        last = run(iters)
        dist.barrier(group=mesh.get_group())
        dt = time.perf_counter() - t0
        finite(last, f"rank {rank}'s chained serving output")
        counts = [b - a for a, b in zip(before, launch_counts())]
        if rank == 0:
            ips = 64 * n * iters / dt
            torch.save({"name": "full_b64_bf16_mesh", "kind": "serving_full_pipeline_mesh", "batch": 64 * n,
                        "devices": n, "dtype": "bfloat16", "fused_blocks": True, "images_per_sec": ips,
                        "images_per_sec_per_card": ips / n, "iters": iters, "steady_state_s": dt,
                        "fused_launches": per_iteration(counts, iters),
                        "peak_mem_gib": torch.cuda.max_memory_allocated(dev) / 2 ** 30}, out_path)
    finally:
        dist.destroy_process_group()


def mesh_record(target_s: float) -> Dict:
    from ..parallel.dryrun import free_port

    n = torch.cuda.device_count()
    with tempfile.TemporaryDirectory() as tmp:
        out_path = os.path.join(tmp, "rank0.pt")
        torch.multiprocessing.spawn(_mesh_rank, args=(n, free_port(), target_s, out_path), nprocs=n, join=True)
        return torch.load(out_path)


def power_limit_w() -> Optional[float]:
    """The card's power limit in W from nvidia-smi, or None without it."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits", "-i", "0"],
                             capture_output=True, text=True, check=True, timeout=30).stdout
        return float(out.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--mesh", action="store_true",
                        help="add full_b64_bf16_mesh: the headline over every card, one rank a card")
    return parser.parse_args(argv)


def main(argv=None) -> Dict:
    """Measures the records on the card and prints them; returns the summary
    (also printed as the last line)."""
    args = parse_args(argv)
    target_s = float(os.environ.get("SWINWNET_BENCH_TARGET_S", "30"))
    only = {s for s in os.environ.get("SWINWNET_BENCH_CONFIGS", "").split(",") if s}
    unknown = only - set(RECORD_NAMES)
    if unknown:
        raise SystemExit(f"SWINWNET_BENCH_CONFIGS names no record: {sorted(unknown)}; the records: {RECORD_NAMES}")
    preflight()
    mesh = args.mesh or os.environ.get("SWINWNET_BENCH_MESH", "") not in ("", "0")
    want = lambda name: not only or name in only
    device = torch.device("cuda")
    card = {"device": torch.cuda.get_device_name(0), "power_limit_w": power_limit_w()}
    t_first = time.perf_counter()
    rng = np.random.default_rng(0)
    records = []

    def measure(make):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        rec = make()
        rec.setdefault("peak_mem_gib", torch.cuda.max_memory_allocated() / 2 ** 30)
        rec.update(card)
        records.append(rec)
        print("# " + json.dumps(rec), flush=True)

    for name, batch, dtype, fused in SERVING:
        if want(name):
            x = rng.uniform(0, 1e3, (batch, 2, H, W)).astype(np.float32)
            measure(lambda: serving_record(name, batch, dtype, fused, x, target_s, device))
    if want("seg_only_b64_bf16"):
        x = rng.uniform(0, 1e3, (64, 2, H, W)).astype(np.float32)
        measure(lambda: seg_only_record(x, target_s, device))
    if want("rl_full_b64_bf16"):
        x = rng.uniform(0, 1e3, (64, 2, H, W)).astype(np.float32)
        measure(lambda: rl_record(x, target_s, device))
    if any(want(name) for name, *_ in TRAINING):
        images = rng.uniform(0, 1e3, (TRAIN_B, 1, H, W)).astype(np.float32)
        masks = (rng.uniform(size=(TRAIN_B, H, W)) > 0.9).astype(np.float32)
        for name, kind, stage, dtype in TRAINING:
            if want(name):
                measure(lambda: training_record(name, kind, stage, dtype, images, masks, target_s, device))
    if any(want(name) for name in LOADER_FED):
        images_np = rng.uniform(0, 1e3, (N_SRC, H, W)).astype(np.float32)
        masks_np = (rng.uniform(size=(N_SRC, H, W)) > 0.9).astype(np.float32)
        for name in LOADER_FED:
            if want(name):
                measure(lambda: loader_record(name, images_np, masks_np, target_s, device))
    if mesh and want("full_b64_bf16_mesh"):
        measure(lambda: mesh_record(target_s))

    if not records:
        raise SystemExit(f"no records were measured: SWINWNET_BENCH_CONFIGS={sorted(only)!r}")
    head = next((r for r in records if r["name"] == "full_b64_bf16"), records[0])
    summary = {"metric": METRIC, "unit": UNIT, "value": head["images_per_sec"], "batch": head["batch"],
               "dtype": head["dtype"], "target_steady_state_s": target_s,
               "wall_s_total": time.perf_counter() - t_first, **card, "records": records}
    if head["name"] != "full_b64_bf16":
        summary["headline_config"] = head["name"]  # the headline was not asked for: say which record this is
    for key in ("gflops_per_image", "mfu_pct"):
        if key in head:
            summary[key] = head[key]
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main()
