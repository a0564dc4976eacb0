"""expand_norm_ms.serve: the device time of the traced slice's
shuffle-and-LayerNorm kernel (the names the metric file gives), a call. It
holds only where the trace and the program agree on the launches: the
kernel's events number the captured graph's count of the metric file's
`counter` a replay (swinwnet_tpu_torch/utils/profiling.py's graph_counts)
times the slice's calls. Where they differ, or the program counts no such
launch (a program without the kernel), it reads nothing, with a note."""

from benchmark.readers import program_ring


def read(run):
    t, m = run.trace, run.metric
    if not t:
        return None
    counts = program_ring.one_graph_counts(run)
    if counts is None:
        return None
    if m["counter"] not in counts:
        run.note(f"{m['name']}: the program counts no {m['counter']} launches")
        return None
    events = [k for k in t["kernels"] if any(n in k[0] for n in m["kernels"])]
    want = counts[m["counter"]] * t["calls"]
    run.note(f"{m['name']}: {len(events)} kernel events in the traced slice, {want} {m['counter']} launches "
             f"counted by the program over its {t['calls']} calls")
    if not events or len(events) != want:
        if events or want:
            run.note(f"{m['name']}: the counts differ, so the time would be of other launches than those counted")
        return None
    return sum(k[2] for k in events) * 1e-3 / t["calls"]
