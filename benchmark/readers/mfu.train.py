"""mfu.train: the reference's operations of the window's steps (forward and
backward of the even and odd objectives; remat's recompute not counted),
over the window's time, as a share of the chip's dense peak in the
configuration's dtype."""

from benchmark.yardstick import flops


def read(run):
    w, cfg = run.window, run.cell.config
    per_image = flops.train_flops_per_image(cfg)
    run.note(f"mfu.train: {per_image} operations an image a step (reference count)")
    ops = w["batch"] * (w["even_steps"] * per_image["even"] + w["odd_steps"] * per_image["odd"])
    return 100.0 * ops / w["elapsed_s"] / flops.PEAK_FLOPS[cfg["dtype"]]
