"""device_idle_pct.*: share of the traced slice's wall time in which no
kernel ran on the device (torch.profiler's CUDA activity). A copy or a set
with no kernel beside it counts as idle. The metric files of
device_idle_pct.serve, .latency and .train name this reader."""


def read(run):
    t = run.trace
    return 100.0 * (1.0 - t["kernel_busy_s"] / t["window_s"]) if t and t["window_s"] > 0 else None
