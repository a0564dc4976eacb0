"""The quality recipe's bf16 training (swinwnet_tpu_torch/recipes/quality_run)
against the JAX script's pipeline with compute_dtype=jnp.bfloat16, on the
same weights and batches: the tiny run through the three stages, the JAX
model with `use_pallas` off (the script's default), the port on its
unfused route on the CPU, SmoothL1SSIMLoss and the flip augmentation.

Each bf16 product rounds its output to 8 bits of mantissa (2^-9 relative)
on both sides, but the two libraries round at other points (XLA fuses
elementwise chains in fp32 where torch rounds each op's output), so the
first epoch's losses are held to 2e-2 relative: about five bf16 steps, the
tolerance the kernels' own bf16 checks use. The HR IoU is a ratio of
thresholded pixel counts, where one pixel near 0.5 flips: within 0.05.
The runs have no validation loader: the JAX side then compiles the three
stages' train steps only (the eval programs would add ~90 s on the CPU).
"""

import jax.numpy as jnp
import numpy as np
import torch

import _torch_port_recipe_helpers as r
from swinwnet_tpu_torch.recipes import quality_run

torch.set_num_threads(1)

BF16_LOSS_RTOL = 2e-2
IOU_ATOL = 0.05


def test_bf16_training_matches_the_jax_pipeline():
    args = r.tiny_args("--compute-dtype", "bf16", "--sr-loss", "SmoothL1SSIMLoss", "--flip-augment")
    data = quality_run.render_data(args)
    model = quality_run.build_model(args, "cpu")
    want = r.jax_histories(args, model, data, jnp.bfloat16, validate=False)
    train_loader, _, kind = quality_run.make_loaders(args, *data[1:])
    got = quality_run.train(args, model, train_loader, None)
    assert kind == "array"
    n = 0
    for name, g, w in r.history_pairs(got, want):
        if "val" in name:  # no validation loader on either side
            assert np.isnan(g) and np.isnan(w), name
        elif name.endswith("iou_hr"):
            assert abs(g - w) <= IOU_ATOL, (name, g, w)
        else:
            assert np.isfinite(g) and abs(g - w) <= BF16_LOSS_RTOL * abs(w), (name, g, w)
            n += 1
    assert n == 2 + 4
