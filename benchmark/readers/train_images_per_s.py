"""train_images_per_s: images of every step over the whole window (host
clock; each step's loss read on the host, as the epoch loop does)."""


def read(run):
    w = run.window
    return w["images"] / w["elapsed_s"]
