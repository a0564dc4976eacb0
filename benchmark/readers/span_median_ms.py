"""The median duration, in ms, of the program's records named by the metric
file's `span` (swinwnet_tpu_torch/utils/profiling.py's ring), over those
made with no profiler recording: the window's calls or steps, and the few
of the warm-up. launch_host_ms.latency, launch_wait_ms.latency and
batch_host_ms.train name this reader. A program without the ring, or
without such records, reads nothing."""

import statistics

from benchmark.readers import program_ring


def read(run):
    name = run.metric["span"]
    records = program_ring.unprofiled(run)
    if records is None:
        return None
    ms = [(r.end_ns - r.start_ns) * 1e-6 for r in records if r.name == name]
    if not ms:
        return None
    run.note(f"{run.metric['name']}: {len(ms)} unprofiled {name} records, from {min(ms)!r} to {max(ms)!r} ms")
    return statistics.median(ms)
