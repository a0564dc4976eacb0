"""Shared set-up of the recipe tests (tests/test_torch_port_recipes*.py):
the JAX scripts loaded from scripts/ as they stand, the quality recipe's
arguments for a tiny CPU run, and the JAX script's training pipeline
(scripts/quality_run.py:267-275) on the port model's weights."""

import importlib.util
import sys
from pathlib import Path

import jax
import jax.numpy as jnp

from swinwnet_tpu.data import ArrayLoader as JaxArrayLoader
from swinwnet_tpu.data.noise import make_theta_flip_augment as jax_flip
from swinwnet_tpu.data.noise import make_train_noise_augment as jax_train_noise
from swinwnet_tpu.models import SwinWNet as JaxSwinWNet
from swinwnet_tpu.train import SwinWNetTrainingPipeline as JaxPipeline
from swinwnet_tpu_torch.compat import jax_tree_from_state_dict
from swinwnet_tpu_torch.recipes import quality_run

REPO = Path(__file__).resolve().parents[1]
SCRIPTS = REPO / "scripts"
# training histories, port against JAX, relative: fp32 in other summation
# orders, as tests/test_torch_port_trainers*.py hold a step's loss
HIST_RTOL = 1e-4


def jax_script(name):
    """scripts/<name>.py as a module (its JAX imports are inside main); the
    sys.path entries the script adds at import are taken back."""
    saved = list(sys.path)
    try:
        spec = importlib.util.spec_from_file_location(f"jax_script_{name}", SCRIPTS / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        sys.path[:] = saved
    return mod


JAX_QR = jax_script("quality_run")


def tiny_args(*extra):
    """The quality recipe's arguments for a tiny CPU run: 4 crystals x 2
    renders to train on (two batches: stage 3's even and odd steps), 6 x 2
    to evaluate, one epoch a stage; main's --tiny geometry applied."""
    args = quality_run.parse_args(["--tiny", "--device", "cpu", "--loader", "array", "--train-crystals", "4",
                                   "--renders-per-crystal", "2", "--eval-renders-per-crystal", "2",
                                   "--seg-epochs", "1", "--sr-epochs", "1", "--full-epochs", "1",
                                   "--warmup-epochs", "1", *extra])
    args.height, args.width = quality_run.TINY_HW
    return args


def jax_histories(args, model, data, compute_dtype, validate=True):
    """The JAX script's pipeline from the port model's weights, on the JAX
    package's ArrayLoaders with the script's augmentations (no validation
    loader unless `validate`)."""
    params = jax.tree_util.tree_map(jnp.asarray, jax_tree_from_state_dict(model.state_dict()))
    _, train_images, train_masks, eval_images, eval_masks = data
    train_loader = JaxArrayLoader(train_images, train_masks, batch_size=args.batch, shuffle=True,
                                  augment=jax_train_noise(), joint_augment=jax_flip() if args.flip_augment else None)
    val_loader = JaxArrayLoader(eval_images, eval_masks, batch_size=args.batch,
                                augment=jax_train_noise(mu_range=(100.0, 100.0)))
    pipe = JaxPipeline(JaxSwinWNet(**quality_run.TINY), params, train_loader, val_loader if validate else None,
                       seg_epochs=args.seg_epochs, sr_epochs=args.sr_epochs, full_epochs=args.full_epochs,
                       warmup_epochs=args.warmup_epochs, sr_loss=args.sr_loss, compute_dtype=compute_dtype,
                       keep_best=args.keep_best, verbose=False)
    return pipe.run()[1]


def history_pairs(got, want):
    """(name, port value, JAX value) for every number of the histories."""
    for stage in ("stage1", "stage2"):
        for k in ("train_loss", "val_loss"):
            for i, (g, w) in enumerate(zip(got[stage][k], want[stage][k], strict=True)):
                yield f"{stage}/{k}/{i}", g, float(w)
    for split in ("train", "val"):
        for i, (g, w) in enumerate(zip(got["stage3"][split], want["stage3"][split], strict=True)):
            assert set(g) == set(w)
            for k in w:
                yield f"stage3/{split}/{i}/{k}", g[k], float(w[k])
