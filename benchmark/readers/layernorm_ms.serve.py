"""layernorm_ms.serve: the device time of the traced slice's LayerNorm
kernels (the names the metric file gives), a call. It holds only where the
trace and the program agree on the launches: the events of those kernels
number the captured graph's `layer_norm` count a replay
(swinwnet_tpu_torch/utils/profiling.py's graph_counts) times the slice's
calls. Where they differ (a LayerNorm that another kernel replaces, or that
launches another kernel, or events the profiler missed), or the program
counts no LayerNorm, it reads nothing, with a note."""

from benchmark.readers import program_ring


def read(run):
    t, m = run.trace, run.metric
    if not t:
        return None
    counts = program_ring.one_graph_counts(run)
    if counts is None or "layer_norm" not in counts:
        return None
    events = [k for k in t["kernels"] if any(n in k[0] for n in m["kernels"])]
    want = counts["layer_norm"] * t["calls"]
    run.note(f"{m['name']}: {len(events)} LayerNorm kernel events in the traced slice, {want} LayerNorms "
              f"counted by the program over its {t['calls']} calls")
    if not events or len(events) != want:
        if events:
            run.note(f"{m['name']}: the counts differ, so the time would be of other launches than those counted")
        return None
    return sum(k[2] for k in events) * 1e-3 / t["calls"]
