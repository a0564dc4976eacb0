"""The reader of narrow_block_ms.serve (the shared reader of its metric file)
on made-up graph counts and traces: the narrow Swin-block body's device time
a call, read only where its events and the program's swin_block_narrow
counter agree."""

from __future__ import annotations

import pytest

from benchmark import harness
from benchmark.tests.conftest import spec
from swinwnet_tpu_torch.utils import profiling

METRIC = "narrow_block_ms.serve"
NARROW = ("void (anonymous namespace)::swin_block_hopper_kernel_narrow<{}, {}>"
          "((anonymous namespace)::NParams)")


def _run(trace) -> harness.Run:
    m = next(m for m in spec()["per_layer"] if m["name"] == METRIC)
    return harness.Run(harness.load_cell("wnet-serve-b64"), {}, trace, 0.0, {**harness.metric_file(METRIC), **m}, [])


def _graphs(monkeypatch, graphs):
    monkeypatch.setattr(profiling, "graph_counts", lambda: graphs)


def _trace(events: int, calls: int = 4) -> dict:
    """`events` narrow launches, alternately C = 24 (1.3 ms) and C = 12 (3.5
    ms), beside the Hopper body's and the FMA body's launches and a
    LayerNorm, which the reader must leave out."""
    kernels = [(NARROW.format(24, 8) if i % 2 == 0 else NARROW.format(12, 4), 10.0 * i,
                1300.0 if i % 2 == 0 else 3500.0) for i in range(events)]
    kernels += [("void (anonymous namespace)::swin_block_hopper_kernel<96, 2, 1, 96, 96, 96>"
                 "((anonymous namespace)::HParams)", 0.0, 8000.0)] * 6
    kernels += [("void (anonymous namespace)::swin_block_kernel<float, true, 8>((anonymous namespace)::Params)",
                 0.0, 900.0)] * 2
    kernels += [("void at::native::(anonymous namespace)::vectorized_layer_norm_kernel<float, float>(int, float)",
                 0.0, 300.0)] * 5
    return {"calls": calls, "kernels": kernels}


def test_the_metric_file_names_the_shared_reader_and_the_narrow_kernel():
    m = harness.metric_file(METRIC)
    assert m["reader"] == "expand_norm_ms.serve" and m["counter"] == "swin_block_narrow"
    assert m["kernels"] == ["swin_block_hopper_kernel_narrow"] and m["workloads"] == ["wnet-serve-b64"]
    assert harness.reader(METRIC) is not None


@pytest.mark.parametrize("calls", [1, 4])
def test_reads_the_narrow_time_a_call_where_events_and_counter_agree(monkeypatch, calls):
    """Four narrow launches a SwinWNet replay (the SR head's two levels, two
    blocks each): their device time a call, the Hopper body's launches left
    out although their name holds the same stem."""
    _graphs(monkeypatch, {"f": [{"layer_norm": 80, "fused_swin_block_cst": 22, "swin_block_narrow": 4}]})
    run = _run(_trace(4 * calls, calls))
    assert harness.reader(METRIC)(run) == pytest.approx(2 * (1.3 + 3.5))
    assert f"{4 * calls} kernel events" in run.notes[0] and f"{4 * calls} swin_block_narrow" in run.notes[0]


@pytest.mark.parametrize("events", [15, 17, 0, 32])
def test_other_event_counts_read_nothing(monkeypatch, events):
    _graphs(monkeypatch, {"f": [{"swin_block_narrow": 4}]})
    run = _run(_trace(events))
    assert harness.reader(METRIC)(run) is None
    assert "counts differ" in run.notes[-1]


@pytest.mark.parametrize("graphs", [{}, {"a": [{"swin_block_narrow": 4}], "b": [{"swin_block_narrow": 4}]},
                                    {"f": [{"layer_norm": 80, "fused_swin_block_cst": 22, "patch_expand_norm": 11}]}])
def test_a_program_without_the_narrow_body_or_one_graph_reads_nothing(monkeypatch, graphs):
    """The parent's program counts no swin_block_narrow (its Hopper body runs
    those levels); no graph, or two."""
    _graphs(monkeypatch, graphs)
    run = _run(_trace(0))
    assert harness.reader(METRIC)(run) is None and run.notes


def test_an_untraced_run_or_a_program_without_the_ring_reads_nothing(monkeypatch):
    assert harness.reader(METRIC)(_run(None)) is None
    monkeypatch.delattr(profiling, "graph_counts")
    monkeypatch.delattr(profiling, "spans")
    run = _run(_trace(16))
    assert harness.reader(METRIC)(run) is None and "keeps no span ring" in run.notes[0]
