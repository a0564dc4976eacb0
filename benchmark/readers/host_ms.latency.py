"""host_ms.latency: mean over the window of the host's span around the
serving entry's call, from the host array to the call's return: the input
copy, the program's key and the replay's launch (host clock)."""


def read(run):
    spans = run.window["host_s"]
    return 1e3 * sum(spans) / len(spans) if spans else None
