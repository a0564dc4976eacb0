"""swin_block_roofline.serve: the least time the fused Swin-block launches of
the traced calls could take on the chip (each launch at the larger of its
operations over the dtype's peak and its bytes over HBM bandwidth; the
levels and shapes from the configuration and the gate in the metric's
file), over the device time of the kernels the file names in the trace.

The share holds only where the trace, the program and the yardstick agree
on the launches: the kernel events in the trace, the program's launch
counters over the same calls, and the gate's launches a call times the
calls. A note states the three counts. Where they differ (a changed gate
or launch shape, or events the profiler missed), or where no such kernel is
in the trace, it reads nothing."""

from benchmark.yardstick import flops


def read(run):
    t, m, cfg = run.trace, run.metric, run.cell.config
    if not t:
        return None
    names = m["kernels"]
    events = [k for k in t["kernels"] if any(n in k[0] for n in names)]
    launches = sum(t["launches"][c] for c in m["counters"])
    bound = flops.swin_block_bound_s(cfg, run.window["batch"], m["gate"][cfg["dtype"]])
    gate = bound["launches"] * t["calls"]
    run.note(f"{m['name']}: {len(events)} fused-block kernel events in the traced slice, {launches} launches "
             f"counted by the program over its {t['calls']} calls, {gate} by the yardstick's gate")
    if not events or not len(events) == launches == gate:
        if events:
            run.note(f"{m['name']}: the counts differ, so the bound would be of other launches than those timed")
        return None
    busy = sum(k[2] for k in events) * 1e-6
    return 100.0 * bound["bound_s"] * t["calls"] / busy
