"""prelaunch_host_ms.latency: the median over requests, made with no
profiler recording, of the time from the request's serve.request span's
start to its program.launch span's start: the host array to the card
(serve.to_device), the program's key and the copy into its static inputs
(swinwnet_tpu_torch/utils/profiling.py's ring)."""

import statistics

from benchmark.readers import program_ring


def read(run):
    records = program_ring.unprofiled(run)
    if records is None:
        return None
    starts = {r.request: r.start_ns for r in records if r.name == "serve.request"}
    ms = [(r.start_ns - starts[r.request]) * 1e-6 for r in records
          if r.name == "program.launch" and r.request in starts]
    if not ms:
        return None
    run.note(f"{run.metric['name']}: {len(ms)} requests with a serve.request and a program.launch span")
    return statistics.median(ms)
