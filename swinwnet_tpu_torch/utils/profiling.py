"""Tracing and stage timing (port of `swinwnet_tpu/utils/profiling.py`).

`trace_context` wraps a block in a `torch.profiler` trace and writes it as a
Chrome trace (chrome://tracing, Perfetto); `StageTimer` accumulates per-stage
times: CUDA events on the card, so that a stage's time is its device time
without a synchronize in the stage, and `perf_counter` on the CPU. The JAX
package's `compilation_cache.py` has no counterpart: eager PyTorch compiles
no graphs.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Optional, Union

import torch

from ..core.device import resolve_device


@contextlib.contextmanager
def trace_context(log_dir: Optional[str]):
    """Profile the enclosed block (CPU, and the card when there is one) and
    write `log_dir/trace.json`; a no-op when `log_dir` is None."""
    if log_dir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class StageTimer:
    """Accumulates per-stage times on `device` (None: the card).

    >>> t = StageTimer()
    >>> with t.stage("segment_1"):
    ...     out = fn(x)
    >>> t.summary()  # mean seconds a stage; waits for the card once
    """

    def __init__(self, device: Optional[Union[str, torch.device]] = None):
        self.cuda = resolve_device(device).type == "cuda"
        self.spans: Dict[str, list] = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        if self.cuda:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            yield
            end.record()
            self.spans.setdefault(name, []).append((start, end))
        else:
            t0 = time.perf_counter()
            yield
            self.spans.setdefault(name, []).append(time.perf_counter() - t0)

    def seconds(self, name: str) -> list:
        """Each span of stage `name`, in seconds."""
        if self.cuda:
            torch.cuda.synchronize()
            return [s.elapsed_time(e) / 1e3 for s, e in self.spans[name]]
        return list(self.spans[name])

    def summary(self) -> Dict[str, float]:
        return {k: sum(self.seconds(k)) / len(self.spans[k]) for k in self.spans}
