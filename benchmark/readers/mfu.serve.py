"""mfu.serve: the reference's operations for the images completed in the
window, over the window's time, as a share of the chip's dense peak in the
configuration's dtype."""

from benchmark.yardstick import flops


def read(run):
    w, cfg = run.window, run.cell.config
    per_image = flops.serving_flops_per_image(cfg)
    run.note(f"mfu.serve: {per_image} operations an image (reference count)")
    return 100.0 * per_image * w["images"] / w["elapsed_s"] / flops.PEAK_FLOPS[cfg["dtype"]]
