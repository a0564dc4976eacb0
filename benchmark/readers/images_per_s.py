"""images_per_s: images handed in and their answers fetched back to the host,
over the whole window (host clock, first call's start to last answer)."""


def read(run):
    w = run.window
    return w["images"] / w["elapsed_s"]
