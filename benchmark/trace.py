"""The traced slice: a few more calls or steps after the window, under
`torch.profiler` (CPU and CUDA activity), reduced to what the per-layer
readers and the breakdown need.

The slice is marked by a `bench.slice` annotation that ends after a
synchronize, so its span on the host's timeline bounds every device
operation of its calls. `busy_s` is the union of the device's kernel,
copy and set intervals inside that span; `kernel_busy_s` the union of its
kernel intervals alone, which `device_idle_pct.*` reads: a copy with no
kernel beside it leaves the card's compute idle. An idle gap is a stretch
of the span with no kernel, named by the innermost host event running at
its middle, and by the copy or set running then, if one is.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Tuple

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")


def launch_counts() -> Dict[str, int]:
    """The program's fused-kernel launch counters, by entry name."""
    from swinwnet_tpu_torch.ops import swin_block

    return {k.__name__: int(k.launches) for k in swin_block.KERNELS}


def profile_slice(loop, calls: int, out_path: Path, device) -> dict:
    from torch.profiler import ProfilerActivity, profile, record_function

    before = launch_counts()
    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function("bench.slice"):
            images = loop.traced_slice(calls)
            torch.cuda.synchronize(device)
    after = launch_counts()
    out_path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(out_path))
    events = json.loads(out_path.read_text())
    events = events["traceEvents"] if isinstance(events, dict) else events
    out = summarize(events)
    out.update(calls=calls, images=images, launches={k: after[k] - before[k] for k in after})
    return out


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    merged: List[List[float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def summarize(events: List[dict]) -> dict:
    """Busy (any device operation), kernel-busy and window seconds, the
    device operations by total time, the gaps between kernels with the
    host's activity, and every kernel event of the slice
    (name, start and duration in us)."""
    spans = [e for e in events if e.get("ph") == "X" and e.get("name") == "bench.slice"
             and e.get("cat") == "user_annotation"]
    if not spans:
        raise RuntimeError("the trace holds no bench.slice span")
    lo = float(spans[0]["ts"])
    hi = lo + float(spans[0]["dur"])
    dev, host = [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        a = float(e["ts"])
        b = a + float(e["dur"])
        if e.get("cat") in DEVICE_CATS and b > lo and a < hi:
            dev.append((max(a, lo), min(b, hi), e["name"], e["cat"]))
        elif e.get("cat") in HOST_CATS and e["name"] != "bench.slice":
            host.append((a, b, e["name"]))
    busy_us = sum(b - a for a, b in _union([(a, b) for a, b, _, _ in dev]))
    busy = _union([(a, b) for a, b, _, cat in dev if cat == "kernel"])
    by_name: Dict[str, float] = {}
    for a, b, name, _ in dev:
        by_name[name] = by_name.get(name, 0.0) + (b - a)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    gaps, at = [], lo
    for a, b in busy + [(hi, hi)]:
        if a > at:
            gaps.append((at, a))
        at = max(at, b)
    gaps.sort(key=lambda g: -(g[1] - g[0]))
    named = []
    for a, b in gaps[:10]:
        mid = 0.5 * (a + b)
        around = [h for h in host if h[0] <= mid <= h[1]]
        label = min(around, key=lambda h: h[1] - h[0])[2] if around else "no host event"
        copying = [name for x, y, name, cat in dev if cat != "kernel" and x <= mid <= y]
        if copying:
            label = f"{copying[0]} (host: {label})"
        named.append([label[:200], (b - a) * 1e-6])
    return {"window_s": (hi - lo) * 1e-6, "busy_s": busy_us * 1e-6,
            "kernel_busy_s": sum(b - a for a, b in busy) * 1e-6,
            "device_ops": [[name[:200], us * 1e-6] for name, us in ops], "idle_gaps": named,
            "kernels": [(name, a, b - a) for a, b, name, cat in dev if cat == "kernel"]}
