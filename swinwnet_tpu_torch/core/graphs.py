"""Compiled programs: a function captured as a CUDA graph once per input
signature, then replayed by one host call (the port's counterpart of
`jax.jit`, which the JAX package's step and inference factories use).

A `Program` wraps `fn(*args)`, whose tensor arguments are its inputs and
whose return value is a tree (tuples, lists, dicts) of tensors and
constants. On a CUDA device its first call with a new signature

1. copies the input tensors into buffers the program keeps (the static
   inputs),
2. warms up: runs `fn` on them once, eagerly, on a side stream, as
   PyTorch's CUDA-graph recipe does; this is the call's result, and it fills
   every device cache that a capture could not fill (the pad and shift
   masks, the interpolation matrices: their host-to-device copies cannot
   run under capture),
3. captures `fn` on the same buffers with `torch.cuda.graph` into the
   program's own memory pool.

A later call with the same signature copies its inputs into the static
buffers, replays the graph and returns clones of its static outputs: new
tensors, which no later call overwrites, as `jax.jit` returns new arrays.
Each call runs `fn`'s work once, the first call too, so a step that updates
a model in place takes one step a call.

The signature is each tensor argument's shape, dtype and device, every other
argument's value (or identity, when it has no hash), the grad mode, and what
the graph reads besides its inputs: the addresses of the modules' parameters
and buffers and of the `state` tensors, and the modules' configuration (every
plain attribute: `dtype`, `fused_blocks`, `training`, ...). Moving a model,
replacing a `Parameter` or switching its compute dtype captures again;
`load_state_dict` copies in place, so the next replay reads the new weights.

Counts stay right under replay: a graph records how much each registered
counter (`count_launches_of`: the fused kernels' launches, `models/layers.py`
LayerNorms and casts) counted while it was captured, adds that much on
every replay, and notes it under the function's name
(`utils.profiling.graph_counts`).

Tracing (`utils.profiling`): a call is split into spans, each with the
function's name as its arg: `program.key` (the signature), then
`program.eager` (the CPU, `run_eagerly`), `program.capture` (a new
signature's warm-up and capture) or `program.copy_in`, `program.launch`
(`graph.replay()`) and `program.clone_out`. Each graph is captured between
two timing events, at its first node and its last, and each replay records
a third on the stream just before its launch; at the program's next call,
if the last event has completed (`query()`; nothing waits), they give the
replay's `device.launch_wait` (launch to first node: how long the card
waited on the host) and `device.graph` records, and one `device.<name>`
record for each `profiling.device_span` the function entered while it was
captured (its pair of events, at their offsets from the first node), else
the replay counts in `graph_events_missed`.

On the CPU (the caller's choice: the CPU has no graphs) a program is its
function, run eagerly. On a CUDA device nothing falls back: a warm-up or a
capture that fails raises. `run_eagerly()` runs every program eagerly for
the block, for a comparison against a route that swaps functions in at run
time (a graph keeps the functions it captured).
"""

from __future__ import annotations

import contextlib
import functools
import gc
import threading
from typing import Callable, Iterable, Iterator, Optional, Sequence

import torch
from torch import nn

from ..utils import profiling
from ..utils.profiling import Counter, count_launches_of, span  # noqa: F401 -- the kernels register through here

_local = threading.local()
EVENTS_MISSED = Counter("graph_events_missed")


def name_of(fn: Callable) -> str:
    """A function's name for spans and counts: its qualified name without
    `<locals>`, through partials and decorators."""
    while isinstance(fn, functools.partial):
        fn = fn.func
    name = getattr(fn, "__qualname__", None) or type(fn).__qualname__
    return name.replace("<locals>.", "")


@contextlib.contextmanager
def run_eagerly() -> Iterator[None]:
    """Every program called in the block runs its function eagerly."""
    depth = getattr(_local, "eager", 0)
    _local.eager = depth + 1
    try:
        yield
    finally:
        _local.eager = depth


_PLAIN = (bool, int, float, str, type(None), torch.dtype, torch.device)


def _flatten(tree, leaves: list):
    """The tree's structure as a hashable value; its leaves appended to `leaves`."""
    if isinstance(tree, (tuple, list)):
        return (type(tree), tuple(_flatten(t, leaves) for t in tree))
    if isinstance(tree, dict):
        return (dict, tuple((k, _flatten(v, leaves)) for k, v in tree.items()))
    leaves.append(tree)
    return None


def _unflatten(struct, leaves: Iterator):
    if struct is None:
        return next(leaves)
    kind, items = struct
    if kind is dict:
        return {k: _unflatten(v, leaves) for k, v in items}
    return kind(_unflatten(t, leaves) for t in items)


def _static_key(x):
    """A non-tensor argument's part of the signature: its value, or its
    identity when it has no hash."""
    try:
        hash(x)
    except TypeError:
        return ("id", id(x))
    return x


class _Watch:
    """The parameters, buffers and configuration of some modules: what a
    graph reads besides its inputs. The walk over the modules is kept and
    rebuilt when a submodule is replaced, so a key costs a few hundred
    dictionary reads instead of a traversal."""

    def __init__(self, modules: Sequence[nn.Module]):
        self.modules = tuple(modules)
        self._children = None

    def _build(self):
        mods = [m for root in self.modules for m in root.modules()]
        self._children = [m._modules for m in mods]
        self._child_ids = self._child_token()
        self._tensors = [(m._parameters, k) for m in mods for k in m._parameters]
        self._tensors += [(m._buffers, k) for m in mods for k in m._buffers]
        self._config = [(m.__dict__, k) for m in mods for k, v in m.__dict__.items()
                        if not k.startswith("_") and isinstance(v, _PLAIN)]

    def _child_token(self):
        return tuple(id(c) for d in self._children for c in d.values())

    def key(self) -> tuple:
        if self._children is None or self._child_token() != self._child_ids:
            self._build()
        ptrs = tuple(0 if d[k] is None else d[k].data_ptr() for d, k in self._tensors)
        return ptrs, tuple(d.get(k) for d, k in self._config)

    def device(self) -> Optional[torch.device]:
        for root in self.modules:
            for p in root.parameters():
                return p.device
        return None


class _Graph:
    """One captured signature: its graph, static inputs and outputs, the
    counts a replay stands for, and its timing events."""

    def __init__(self, graph, inputs, out_struct, outputs, counts, events, spans, device):
        self.graph, self.inputs, self.device = graph, inputs, device
        self.out_struct, self.outputs, self.counts = out_struct, outputs, counts
        self.first, self.last = events
        self.spans = spans  # (name, start event, end event) of each device span captured
        self.before = torch.cuda.Event(enable_timing=True)
        self.stream = (None, None)  # the raw stream last launched on, and its Stream
        self.launch = None  # the span of a replay whose events are not read yet

    def __call__(self, tensors: Sequence[torch.Tensor], name: str):
        with span("program.copy_in", name):
            for dst, src in zip(self.inputs, tensors):
                dst.copy_(src)
        with span("program.launch", name) as launch:
            self.before.record(self._current_stream())
            self.graph.replay()
        self.launch = launch
        for entry, n in self.counts:
            entry.launches += n
        with span("program.clone_out", name):
            return _unflatten(self.out_struct, iter(_fresh(x) for x in self.outputs))

    def _current_stream(self) -> torch.cuda.Stream:
        """The stream a replay launches on; its Stream object made again
        only when it changes."""
        raw = torch._C._cuda_getCurrentRawStream(self.device.index)
        if raw != self.stream[0]:
            self.stream = (raw, torch.cuda.current_stream(self.device))
        return self.stream[1]

    def read_events(self) -> None:
        """The last replay's device records, if its events have completed."""
        launch, self.launch = self.launch, None
        if not self.last.query():
            EVENTS_MISSED.launches += 1
            return
        wait = round(self.before.elapsed_time(self.first) * 1e6)
        run = round(self.first.elapsed_time(self.last) * 1e6)
        at = launch.start + wait
        profiling.record("device.launch_wait", launch, launch.start, at)
        profiling.record("device.graph", launch, at, at + run)
        for name, start, end in self.spans:
            offset = round(self.first.elapsed_time(start) * 1e6)
            profiling.record("device." + name, launch, at + offset, at + offset + round(start.elapsed_time(end) * 1e6))


def _fresh(x):
    return x.clone() if isinstance(x, torch.Tensor) else x


class Program:
    """`fn` as a CUDA graph captured once per signature (see the module
    docstring). `modules` are the modules whose parameters, buffers and
    configuration `fn` reads (or updates in place); `state(*args)` gives any
    other tensors it reads or updates in place, such as an optimizer's
    moments. `donate` is accepted for `jax.jit`'s `donate_argnums`: a caller
    that donates may not find its input intact afterwards (here the inputs
    are copied and left as they were)."""

    def __init__(self, fn: Callable, modules: Sequence[nn.Module] = (),
                 state: Optional[Callable[..., Iterable[torch.Tensor]]] = None, donate: bool = False):
        self.fn, self.donate = fn, donate
        self.name = name_of(fn)
        self._watch = _Watch(modules)
        self._state = state
        self._graphs = {}
        self._pool = None
        self._unread: Optional[_Graph] = None  # the graph last replayed, its events not read yet

    @property
    def num_graphs(self) -> int:
        """Signatures captured so far."""
        return len(self._graphs)

    def __call__(self, *args):
        unread, self._unread = self._unread, None
        if unread is not None:
            unread.read_events()
        name = self.name
        with span("program.key", name):
            leaves: list = []
            struct = _flatten(args, leaves)
            tensors = [x for x in leaves if isinstance(x, torch.Tensor)]
            device = tensors[0].device if tensors else self._watch.device()
            eager = device is None or device.type != "cuda" or getattr(_local, "eager", 0)
            if not eager:
                state = () if self._state is None else tuple(t.data_ptr() for t in self._state(*args))
                key = (struct, torch.is_grad_enabled(),
                       tuple((tuple(x.shape), x.dtype, x.device) if isinstance(x, torch.Tensor) else _static_key(x)
                             for x in leaves),
                       self._watch.key(), state)
                graph = self._graphs.get(key)
        if eager:
            with span("program.eager", name):
                return self.fn(*args)
        if graph is None:
            with span("program.capture", name):
                return self._capture(key, struct, leaves, device)
        out = graph(tensors, name)
        self._unread = graph
        return out

    def _capture(self, key, struct, leaves, device):
        """Warm up on static copies of the inputs (the call's result), then
        capture the graph that later calls replay."""
        with torch.inference_mode(False):  # buffers a later call outside inference mode may copy into
            static = [x.detach().clone() if isinstance(x, torch.Tensor) else x for x in leaves]
        args = _unflatten(struct, iter(static))
        ambient = torch.cuda.current_stream(device)
        side = torch.cuda.Stream(device)
        side.wait_stream(ambient)
        with torch.cuda.stream(side):
            warm = self.fn(*args)
        ambient.wait_stream(side)
        # the call's result, as new tensors of the ambient stream: a warm-up
        # output may be a static input, which the next replay overwrites
        out_leaves: list = []
        out_struct = _flatten(warm, out_leaves)
        result = _unflatten(out_struct, iter(_fresh(x) for x in out_leaves))
        del warm, out_leaves

        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        events = (torch.cuda.Event(enable_timing=True, external=True),
                  torch.cuda.Event(enable_timing=True, external=True))
        counted = list(profiling.COUNTERS)
        before = [entry.launches for entry in counted]
        # no garbage collection while capturing: collecting a dead cycle that
        # holds another program's graph would destroy that graph, a CUDA call
        # the capture does not allow, and the capture would fail
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.device(device), torch.cuda.graph(graph, pool=self._pool), \
                    profiling.device_spans() as spans:
                events[0].record()
                captured = self.fn(*args)
                events[1].record()
        finally:
            if collecting:
                gc.enable()
            # the capture ran no kernel: its counts are added on replay
            counts = [(entry, entry.launches - b) for entry, b in zip(counted, before)]
            for entry, b in zip(counted, before):
                entry.launches = b
        outputs: list = []
        captured_struct = _flatten(captured, outputs)
        if captured_struct != out_struct:
            raise RuntimeError("the captured function returned another structure than its warm-up")
        static_inputs = [x for x in static if isinstance(x, torch.Tensor)]
        profiling.note_capture(self.name, {entry.__name__: n for entry, n in counts})
        self._graphs[key] = _Graph(graph, static_inputs, out_struct, outputs, [(e, n) for e, n in counts if n],
                                   events, spans, device)
        return result
