"""mfu.rl: the reference's operations of the window's REINFORCE steps (the
preprocess, the policy, the rollout and the supervised update, forward and
backward; the reward's rebin and peak search and remat's recompute not
counted), over the window's time, as a share of the chip's dense peak in
the configuration's dtype."""

from benchmark.yardstick import flops, flops_rl


def read(run):
    w, cfg = run.window, run.cell.config
    per_image = flops_rl.rl_flops_per_image(cfg)
    run.note(f"mfu.rl: {per_image} operations an image a step (reference count)")
    return 100.0 * per_image * w["images"] / w["elapsed_s"] / flops.PEAK_FLOPS[cfg["dtype"]]
