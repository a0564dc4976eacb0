"""The port's tracing: spans in an in-memory ring, counters kept right under
graph replay, and the `torch.profiler` exporter (the JAX package's
`utils/profiling.py` has a `jax.profiler` trace context; its
`compilation_cache.py` has no counterpart).

Spans. `with span(name, arg):` records the span's name, its `arg` (a
program's function name, or None), the span that encloses it on this
thread (its parent), a request id, and its start and end from
`time.perf_counter_ns`. A span opened outside any other (a root) opens a new
request id; the spans inside it take that id. Each record goes into one
slot of a ring of `RING` records allocated once, when the span ends, so
the ring never grows and holds the last `RING` records to end. While a `torch.profiler` is
recording, a span also enters `torch.profiler.record_function(name)` (its
args: the request id and `arg`), so that it shows in the Chrome trace,
nested, on the clock of the kernel and copy events; such a record is
flagged `profiled`, so that readers can keep timings taken under the
profiler apart. Without a profiler a span costs one global read for it.

Records named `device.*` are made by `core.graphs` from CUDA events: their
duration is the device's (`device.launch_wait`: from an event recorded just
before a graph's launch to the graph's first node; `device.graph`: from its
first node to its last), their start the host's time at the launch, their
parent the `program.launch` span of that replay.

Device spans. `with device_span(name):` inside a function that a `Program`
captures records a pair of timing events into the graph around the
enclosed work, and each replay gives a `device.<name>` record: its start
and length the pair's offsets from the graph's first node, within that
replay's `device.graph`. Run eagerly (the warm-up, `run_eagerly`, the CPU)
it is a host `span(name)`.

Counters. A counter is any object with an int `launches` and a `__name__`
(the fused Swin-block entries of `ops/swin_block.py`, the `Counter`s of
`models/layers.py`); `count_launches_of` registers it, and a graph that
`core.graphs` captures adds on every replay the counts its capture made.

Read-out: `spans()`, `counters()`, `graph_counts()`, `write_spans(path)`;
`trace_context(log_dir)` writes a Chrome trace and the spans made in it.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
from time import perf_counter_ns
from typing import Any, Dict, Iterator, List, NamedTuple, Optional

import torch
import torch.autograd.profiler as _autograd_profiler

RING = 1 << 18  # records kept: about 8 spans a request over 30 000 requests
_MASK = RING - 1


class Span(NamedTuple):
    seq: int  # order of opening, from 0
    name: str
    parent: int  # the enclosing span's seq; -1 for a root
    request: int  # the root's request id, from 1
    start_ns: int
    end_ns: int
    profiled: bool  # made while a torch.profiler was recording
    arg: Optional[str]


_ring: List[Optional[tuple]] = [None] * RING
_seq = itertools.count()  # spans in order of opening
_writes = itertools.count()  # records in order of ending: the next one's slot
_requests = itertools.count(1)
COUNTERS: List[Any] = []  # registered counters, in order
_GRAPHS: Dict[str, List[Dict[str, int]]] = {}


class _Open(threading.local):
    def __init__(self):
        self.spans: List["span"] = []


_open = _Open()


class span:
    """A span of the enclosed block (see the module docstring); `seq` and
    `request` are readable inside it and after it."""

    __slots__ = ("name", "arg", "seq", "parent", "request", "start", "annotation", "stack")

    def __init__(self, name: str, arg: Optional[str] = None):
        self.name, self.arg = name, arg

    def __enter__(self) -> "span":
        self.stack = stack = _open.spans
        if stack:
            top = stack[-1]
            self.parent, self.request = top.seq, top.request
        else:
            self.parent, self.request = -1, next(_requests)
        self.seq = next(_seq)
        stack.append(self)
        if _autograd_profiler._is_profiler_enabled:
            args = f"request={self.request}" if self.arg is None else f"request={self.request} fn={self.arg}"
            self.annotation = torch.profiler.record_function(self.name, args)
            self.annotation.__enter__()
        else:
            self.annotation = None
        self.start = perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        end = perf_counter_ns()
        annotation = self.annotation
        if annotation is not None:
            annotation.__exit__(None, None, None)
        self.stack.pop()
        _ring[next(_writes) & _MASK] = (self.seq, self.name, self.parent, self.request, self.start, end,
                                        annotation is not None or _autograd_profiler._is_profiler_enabled, self.arg)


def record(name: str, parent: span, start_ns: int, end_ns: int) -> None:
    """A record made after `parent` ended (the `device.*` records): its
    child, in its request, with its arg, profiled if it was."""
    _ring[next(_writes) & _MASK] = (next(_seq), name, parent.seq, parent.request, start_ns, end_ns,
                                    parent.annotation is not None, parent.arg)


class _Capturing(threading.local):
    def __init__(self):
        self.pairs: List[List[tuple]] = []


_capturing = _Capturing()


@contextlib.contextmanager
def device_spans() -> Iterator[List[tuple]]:
    """The block is a graph's capture: the device spans entered in it append
    (name, start event, end event) to the list yielded."""
    pairs: List[tuple] = []
    _capturing.pairs.append(pairs)
    try:
        yield pairs
    finally:
        _capturing.pairs.pop()


class device_span:
    """A span of the device's work in the enclosed block where a graph is
    being captured, else a host `span` (see the module docstring)."""

    __slots__ = ("name", "host", "pair")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self) -> "device_span":
        if _capturing.pairs:
            self.host = None
            self.pair = (self.name, torch.cuda.Event(enable_timing=True, external=True),
                         torch.cuda.Event(enable_timing=True, external=True))
            self.pair[1].record()
        else:
            self.host = span(self.name)
            self.host.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        if self.host is not None:
            self.host.__exit__(*exc)
            return
        self.pair[2].record()
        _capturing.pairs[-1].append(self.pair)


class Counter:
    """A named count with the kernel entries' interface (`__name__`, an
    int `launches`), registered for `counters()` and graph replay."""

    def __init__(self, name: str):
        self.__name__, self.launches = name, 0
        count_launches_of(self)


def count_launches_of(*entries) -> None:
    """Register counters: objects whose `launches` attribute counts what
    they count. A graph that captures them adds their counts on replay."""
    COUNTERS.extend(entries)


def note_capture(name: str, counts: Dict[str, int]) -> None:
    """A captured graph's counts a replay adds, under its function's name."""
    _GRAPHS.setdefault(name, []).append(dict(counts))


# ---- read-out ---------------------------------------------------------------


def spans(since_ns: int = 0) -> List[Span]:
    """The ring's records (the last `RING` to end) that started at or after
    `since_ns`, in order of opening."""
    return [Span(*r) for r in sorted(r for r in _ring if r is not None and r[4] >= since_ns)]


def counters() -> Dict[str, int]:
    """Each registered counter's total."""
    return {c.__name__: int(c.launches) for c in COUNTERS}


def graph_counts() -> Dict[str, List[Dict[str, int]]]:
    """By function name, each captured graph's counts that one replay adds."""
    return {name: [dict(c) for c in graphs] for name, graphs in _GRAPHS.items()}


def write_spans(path: str, since_ns: int = 0) -> int:
    """`spans(since_ns)` as JSON lines; returns how many."""
    records = spans(since_ns)
    with open(path, "w") as f:
        for r in records:
            f.write(json.dumps(r._asdict()) + "\n")
    return len(records)


@contextlib.contextmanager
def trace_context(log_dir: Optional[str]):
    """Profile the enclosed block (CPU, and the card when there is one) and
    write `log_dir/trace.json` and the spans it made, `log_dir/spans.jsonl`;
    a no-op when `log_dir` is None."""
    if log_dir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    os.makedirs(log_dir, exist_ok=True)
    start = perf_counter_ns()
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
    write_spans(os.path.join(log_dir, "spans.jsonl"), start)
