"""The traced slice's reduction and the readers over it, on made-up traces."""

from __future__ import annotations

from benchmark import harness, trace
from benchmark.tests.conftest import spec


def _x(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


def test_idle_counts_a_copy_with_no_kernel_beside_it():
    """A 100 us slice: kernels over 0-10 and 30-40, a device-to-host copy over
    10-30 while the host waits in its copy call, nothing over 40-100."""
    events = [
        _x("bench.slice", "user_annotation", 0, 100),
        _x("gemm", "kernel", 0, 10), _x("Memcpy DtoH (Device -> Pageable)", "gpu_memcpy", 10, 20),
        _x("gemm", "kernel", 30, 10), _x("cudaMemcpyAsync", "cuda_runtime", 9, 22),
        _x("aten::copy_", "cpu_op", 8, 24), _x("bench.read", "user_annotation", 40, 60),
    ]
    t = trace.summarize(events)
    assert abs(t["busy_s"] - 40e-6) < 1e-12 and abs(t["kernel_busy_s"] - 20e-6) < 1e-12
    assert abs(t["window_s"] - 100e-6) < 1e-12
    (first, s1), (second, s2) = t["idle_gaps"]
    assert first == "bench.read" and abs(s1 - 60e-6) < 1e-12
    assert second == "Memcpy DtoH (Device -> Pageable) (host: cudaMemcpyAsync)" and abs(s2 - 20e-6) < 1e-12
    run = harness.Run(None, {}, t, 0.0, {}, [])
    assert abs(harness.reader("device_idle_pct.serve")(run) - 80.0) < 1e-9


def _roofline_run(events: int, counted: int) -> harness.Run:
    cell = harness.load_cell("wnet-serve-b64")
    m = next(m for m in spec()["per_layer"] if m["name"] == "swin_block_roofline.serve")
    kernels = [("void swin_block_hopper_kernel<96>(Args)", 10.0 * i, 100.0) for i in range(events)]
    t = {"calls": 1, "kernels": kernels,
         "launches": {"fused_swin_block_cst": counted, "fused_swin_block": 0, "fused_swin_block_wide": 0}}
    return harness.Run(cell, {"batch": 64}, t, 0.0, {**harness.metric_file(m["name"]), **m}, [])


def test_roofline_reads_only_where_trace_counters_and_gate_agree():
    """SwinWNet's gate fuses 22 launches a call: the share is read when the
    trace and the counters both hold 22, and left out when either differs."""
    read = harness.reader("swin_block_roofline.serve")
    run = _roofline_run(22, 22)
    share = read(run)
    assert share is not None and 0.0 < share
    assert "22 fused-block kernel events" in run.notes[0]
    for events, counted in ((21, 22), (22, 21), (21, 21), (0, 22)):
        run = _roofline_run(events, counted)
        assert read(run) is None, (events, counted)
        assert run.notes
