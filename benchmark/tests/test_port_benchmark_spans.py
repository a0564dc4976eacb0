"""The readers of the program's spans and counters, on made-up rings, graph
counts and traces."""

from __future__ import annotations

import pytest

from benchmark import harness
from benchmark.tests.conftest import spec
from swinwnet_tpu_torch.utils import profiling
from swinwnet_tpu_torch.utils.profiling import Span


def _run(metric: str, cell: str, trace=None) -> harness.Run:
    m = next(m for m in spec()["per_layer"] if m["name"] == metric)
    return harness.Run(harness.load_cell(cell), {}, trace, 0.0, {**harness.metric_file(metric), **m}, [])


def _ring(monkeypatch, records, graphs=None):
    monkeypatch.setattr(profiling, "spans", lambda since_ns=0: list(records))
    monkeypatch.setattr(profiling, "graph_counts", lambda: graphs or {})


def _request(request: int, seq: int, t0: int, profiled: bool, launch_at: int, launch_ns: int):
    """serve.request > serve.to_device, program.key, program.copy_in,
    program.launch, program.clone_out, device.launch_wait (ns)."""
    root = Span(seq, "serve.request", -1, request, t0, t0 + 10_000_000, profiled, None)
    launch = Span(seq + 4, "program.launch", seq, request, t0 + launch_at, t0 + launch_at + launch_ns, profiled, "f")
    return [root,
            Span(seq + 1, "serve.to_device", seq, request, t0 + 1000, t0 + 2000, profiled, None),
            Span(seq + 2, "program.key", seq, request, t0 + 2000, t0 + 3000, profiled, "f"),
            Span(seq + 3, "program.copy_in", seq, request, t0 + 3000, t0 + launch_at, profiled, "f"),
            launch,
            Span(seq + 5, "program.clone_out", seq, request, launch.end_ns, launch.end_ns + 500, profiled, "f"),
            Span(seq + 6, "device.launch_wait", seq + 4, request, launch.start_ns, launch.start_ns + 30_000,
                 profiled, "f")]


def test_span_medians_leave_out_profiled_records(monkeypatch):
    """Three unprofiled requests whose launches take 0.2, 0.4 and 0.3 ms and
    begin 0.05, 0.07, 0.06 ms into the request; two profiled ones at 9 ms."""
    records = []
    for k, (at, ns, prof) in enumerate([(50_000, 200_000, False), (70_000, 400_000, False),
                                        (60_000, 300_000, False), (9_000_000, 9_000_000, True),
                                        (9_000_000, 9_000_000, True)]):
        records += _request(k + 1, 10 * k, 10**9 * (k + 1), prof, at, ns)
    _ring(monkeypatch, records)
    launch = harness.reader("launch_host_ms.latency")(_run("launch_host_ms.latency", "wnet-serve-b1"))
    prelaunch = harness.reader("prelaunch_host_ms.latency")(_run("prelaunch_host_ms.latency", "wnet-serve-b1"))
    wait = harness.reader("launch_wait_ms.latency")(_run("launch_wait_ms.latency", "wnet-serve-b1"))
    assert launch == pytest.approx(0.3) and prelaunch == pytest.approx(0.06) and wait == pytest.approx(0.03)


def test_batch_median_reads_the_training_steps(monkeypatch):
    records = [Span(2 * k, "train.step", -1, k + 1, 0, 10**7, k == 3, None) for k in range(4)]
    records += [Span(2 * k + 1, "train.batch", 2 * k, k + 1, 0, ns, k == 3, None)
                for k, ns in enumerate([100_000, 300_000, 200_000, 5_000_000])]
    _ring(monkeypatch, records)
    run = _run("batch_host_ms.train", "wnet-train-s3-b4")
    assert harness.reader("batch_host_ms.train")(run) == pytest.approx(0.2)
    assert "3 unprofiled train.batch records" in run.notes[0]


def test_a_program_without_the_ring_reads_nothing(monkeypatch):
    monkeypatch.delattr(profiling, "spans")
    monkeypatch.delattr(profiling, "graph_counts")
    cases = [("launch_host_ms.latency", "wnet-serve-b1", None), ("prelaunch_host_ms.latency", "wnet-serve-b1", None),
             ("batch_host_ms.train", "wnet-train-s3-b4", None),
             ("weight_casts.serve", "wnet-serve-b64", None),
             ("layernorm_ms.serve", "unet-seg-b64", {"calls": 2, "kernels": []})]
    for metric, cell, trace in cases:
        run = _run(metric, cell, trace)
        assert harness.reader(metric)(run) is None, metric
        assert "keeps no span ring" in run.notes[0], metric


def _ln_trace(events: int, calls: int = 4) -> dict:
    kernels = [("void at::native::(anonymous namespace)::vectorized_layer_norm_kernel<float, float>(int, float)",
                10.0 * i, 250.0) for i in range(events)]
    kernels += [("void swin_block_hopper_kernel<96>(Args)", 0.0, 1000.0)]
    return {"calls": calls, "kernels": kernels}


def test_layernorm_reads_only_where_events_and_counter_agree(monkeypatch):
    """A replay counts 39 LayerNorms: over 4 calls the share is read from 156
    events (250 us each: 9.75 ms a call), and left out with a note when the
    trace holds another number, or when no graph or two were captured."""
    read = harness.reader("layernorm_ms.serve")
    _ring(monkeypatch, [], {"make_segmentation_fn.segment": [{"layer_norm": 39, "weight_cast": 146}]})
    run = _run("layernorm_ms.serve", "unet-seg-b64", _ln_trace(156))
    assert read(run) == pytest.approx(9.75)
    assert "156 LayerNorm kernel events" in run.notes[0] and "156 LayerNorms" in run.notes[0]
    for events in (155, 157, 0, 312):
        run = _run("layernorm_ms.serve", "unet-seg-b64", _ln_trace(events))
        assert read(run) is None, events
        assert run.notes
    for graphs in ({}, {"a": [{"layer_norm": 39}], "b": [{"layer_norm": 39}]}, {"a": [{"weight_cast": 3}]}):
        _ring(monkeypatch, [], graphs)
        assert read(_run("layernorm_ms.serve", "unet-seg-b64", _ln_trace(156))) is None, graphs
    assert read(_run("layernorm_ms.serve", "unet-seg-b64", None)) is None


def test_weight_casts_read_the_one_captured_graph(monkeypatch):
    read = harness.reader("weight_casts.serve")
    _ring(monkeypatch, [], {"inference_stages": [{"layer_norm": 135, "weight_cast": 492}]})
    assert read(_run("weight_casts.serve", "wnet-serve-b64")) == 492
    _ring(monkeypatch, [], {"inference_stages": [{"weight_cast": 492}, {"weight_cast": 492}]})
    run = _run("weight_casts.serve", "wnet-serve-b64")
    assert read(run) is None and "2 captured graphs" in run.notes[0]
