"""The reader of expand_norm_ms.serve on made-up graph counts and traces: it
reads only where the kernel's events and the program's counter agree."""

from __future__ import annotations

import pytest

from benchmark import harness
from benchmark.tests.conftest import spec
from swinwnet_tpu_torch.utils import profiling

METRIC = "expand_norm_ms.serve"


def _run(cell: str, trace) -> harness.Run:
    m = next(m for m in spec()["per_layer"] if m["name"] == METRIC)
    return harness.Run(harness.load_cell(cell), {}, trace, 0.0, {**harness.metric_file(METRIC), **m}, [])


def _graphs(monkeypatch, graphs):
    monkeypatch.setattr(profiling, "graph_counts", lambda: graphs)


def _trace(events: int, calls: int = 4) -> dict:
    """`events` launches of the kernel at 200 us each, beside torch's
    LayerNorms and a Swin-block kernel that the reader must leave out."""
    kernels = [("void (anonymous namespace)::expand_norm_kernel<(anonymous namespace)::Bf16, 16>"
                "(unsigned short const*, unsigned short*, float const*, float const*, int, int, int, int)",
                10.0 * i, 200.0) for i in range(events)]
    kernels += [("void at::native::(anonymous namespace)::vectorized_layer_norm_kernel<float, float>(int, float)",
                 0.0, 300.0)] * 5
    kernels += [("void swin_block_hopper_kernel<96>(Args)", 0.0, 1000.0)]
    return {"calls": calls, "kernels": kernels}


@pytest.mark.parametrize("cell,per_replay", [("wnet-serve-b64", 11), ("unet-seg-b64", 3)])
def test_reads_the_kernel_time_a_call_where_events_and_counter_agree(monkeypatch, cell, per_replay):
    _graphs(monkeypatch, {"f": [{"layer_norm": 80, "patch_expand_norm": per_replay}]})
    run = _run(cell, _trace(4 * per_replay))
    assert harness.reader(METRIC)(run) == pytest.approx(per_replay * 0.2)
    assert f"{4 * per_replay} kernel events" in run.notes[0] and f"{4 * per_replay} patch_expand_norm" in run.notes[0]


@pytest.mark.parametrize("events", [43, 45, 0, 88])
def test_other_event_counts_read_nothing(monkeypatch, events):
    _graphs(monkeypatch, {"f": [{"patch_expand_norm": 11}]})
    run = _run("wnet-serve-b64", _trace(events))
    assert harness.reader(METRIC)(run) is None
    assert "counts differ" in run.notes[-1]


@pytest.mark.parametrize("graphs", [{}, {"a": [{"patch_expand_norm": 3}], "b": [{"patch_expand_norm": 3}]},
                                    {"f": [{"layer_norm": 91, "weight_cast": 428}]}])
def test_a_program_without_the_kernel_or_one_graph_reads_nothing(monkeypatch, graphs):
    """The parent's program counts LayerNorms only; no graph, or two."""
    _graphs(monkeypatch, graphs)
    run = _run("unet-seg-b64", _trace(12))
    assert harness.reader(METRIC)(run) is None and run.notes


def test_an_untraced_run_or_a_program_without_the_ring_reads_nothing(monkeypatch):
    assert harness.reader(METRIC)(_run("wnet-serve-b64", None)) is None
    monkeypatch.delattr(profiling, "graph_counts")
    monkeypatch.delattr(profiling, "spans")
    run = _run("wnet-serve-b64", _trace(44))
    assert harness.reader(METRIC)(run) is None and "keeps no span ring" in run.notes[0]
