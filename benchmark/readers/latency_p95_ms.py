"""latency_p95_ms: the 95th percentile over every request of the window, from
the host array handed in to the answer on the host (host clock)."""

import numpy as np


def read(run):
    lat = np.asarray(run.window["latency_s"]) * 1e3
    if not len(lat):
        return None
    p50, p95, p99 = np.percentile(lat, [50, 95, 99])
    run.note(f"latency_p95_ms: {len(lat)} requests, p50 {p50!r} p95 {p95!r} p99 {p99!r} max {lat.max()!r} ms")
    return float(p95)
