"""The reader of window_attention_ms.serve (the shared reader of its metric
file) on made-up graph counts and traces: the window attention kernel's
device time a call, read only where its events and the program's
window_attention counter agree, in either serving cell."""

from __future__ import annotations

import pytest

from benchmark import harness
from benchmark.tests.conftest import spec
from swinwnet_tpu_torch.utils import profiling

METRIC = "window_attention_ms.serve"
KERNEL = "void (anonymous namespace)::window_attention_kernel<{}>((anonymous namespace)::Params)"
# a replay's launches: 30 in SwinWNet (three towers' five unfused levels, two
# blocks each), 10 in SwinUNet
PER_REPLAY = {"wnet-serve-b64": 30, "unet-seg-b64": 10}


def _run(cell: str, trace) -> harness.Run:
    m = next(m for m in spec()["per_layer"] if m["name"] == METRIC)
    return harness.Run(harness.load_cell(cell), {}, trace, 0.0, {**harness.metric_file(METRIC), **m}, [])


def _graphs(monkeypatch, graphs):
    monkeypatch.setattr(profiling, "graph_counts", lambda: graphs)


def _trace(events: int, calls: int = 4) -> dict:
    """`events` launches of the kernel, alternately hd = 16 (100 us) and 32
    (300 us), beside the Swin-block kernels, torch's fp32 GEMM and softmax
    and a LayerNorm, which the reader must leave out."""
    kernels = [(KERNEL.format(16 if i % 2 == 0 else 32), 10.0 * i, 100.0 if i % 2 == 0 else 300.0)
               for i in range(events)]
    kernels += [("void (anonymous namespace)::swin_block_hopper_kernel<96, 2, 1, 96, 96, 96>"
                 "((anonymous namespace)::HParams)", 0.0, 8000.0)] * 6
    kernels += [("sm80_xmma_gemm_f32f32_f32f32_f32_nn_n_tilesize32x32x8_stage3_warpsize1x2x1_ffma_aligna4_alignc4_"
                 "execute_kernel_trans", 0.0, 400.0)] * 3
    kernels += [("void (anonymous namespace)::softmax_warp_forward<float, float, float, 5, false, false>"
                 "(float*, float const*, int, int, int, bool const*, int, bool)", 0.0, 50.0)] * 3
    kernels += [("void at::native::(anonymous namespace)::vectorized_layer_norm_kernel<float, float>(int, float)",
                 0.0, 300.0)] * 5
    return {"calls": calls, "kernels": kernels}


def test_the_metric_file_names_the_shared_reader_and_the_kernel():
    m = harness.metric_file(METRIC)
    assert m["reader"] == "expand_norm_ms.serve" and m["counter"] == "window_attention"
    assert m["kernels"] == ["window_attention_kernel"] and m["workloads"] == ["wnet-serve-b64", "unet-seg-b64"]
    assert m["moves"] == "images_per_s" and harness.reader(METRIC) is not None


@pytest.mark.parametrize("calls", [1, 4])
@pytest.mark.parametrize("cell", sorted(PER_REPLAY))
def test_reads_the_kernel_time_a_call_where_events_and_counter_agree(monkeypatch, cell, calls):
    per_replay = PER_REPLAY[cell]
    _graphs(monkeypatch, {"f": [{"layer_norm": 80, "fused_swin_block_cst": 22, "window_attention": per_replay}]})
    run = _run(cell, _trace(per_replay * calls, calls))
    assert harness.reader(METRIC)(run) == pytest.approx(per_replay // 2 * (0.1 + 0.3))
    assert (f"{per_replay * calls} kernel events" in run.notes[0]
            and f"{per_replay * calls} window_attention" in run.notes[0])


@pytest.mark.parametrize("events", [119, 121, 0, 240])
def test_other_event_counts_read_nothing(monkeypatch, events):
    """Events that are not 30 a call over 4 calls: launches the program did
    not count, or counted launches the trace lacks."""
    _graphs(monkeypatch, {"f": [{"window_attention": 30}]})
    run = _run("wnet-serve-b64", _trace(events))
    assert harness.reader(METRIC)(run) is None
    assert "counts differ" in run.notes[-1]


@pytest.mark.parametrize("graphs", [{}, {"a": [{"window_attention": 10}], "b": [{"window_attention": 10}]},
                                    {"f": [{"layer_norm": 24, "fused_swin_block_cst": 6, "patch_expand_norm": 3}]}])
def test_a_program_without_the_kernel_or_one_graph_reads_nothing(monkeypatch, graphs):
    """The parent's program counts no window_attention (its unfused levels
    run the plain chain); no graph, or two."""
    _graphs(monkeypatch, graphs)
    run = _run("unet-seg-b64", _trace(0))
    assert harness.reader(METRIC)(run) is None and run.notes


def test_an_untraced_run_or_a_program_without_the_ring_reads_nothing(monkeypatch):
    assert harness.reader(METRIC)(_run("wnet-serve-b64", None)) is None
    monkeypatch.delattr(profiling, "graph_counts")
    monkeypatch.delattr(profiling, "spans")
    run = _run("wnet-serve-b64", _trace(120))
    assert harness.reader(METRIC)(run) is None and "keeps no span ring" in run.notes[0]
