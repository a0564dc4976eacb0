"""RL fine-tuning run: the REINFORCE alpha policy on top of a supervised
checkpoint -> reward curve, learned-alpha statistics and physical metrics
before and after in the published results schema (port of
`scripts/rl_run.py`; BASELINE config #5, the reference's
RL_finetuning_pipline.py:168-307).

The reward is the on-device d-space metric (`physics.device_metrics`), so
the step stays on the card; the reference crosses to scipy every batch.
Data and eval protocol are the quality run's (same crystal library seeds,
held-out set and noise passes); the starting weights are its checkpoint:

    python -m swinwnet_tpu_torch.recipes.rl_run --ckpt QUALITY_r04_ckpt \\
        --out QUALITY_r04_rl --epochs 20 --train-crystals 32 --renders-per-crystal 4

Writes `{out}.json`, `{out}_physical_metrics.json` and the checkpoint
`{out}_ckpt` ({"params", "policy", "model"}). Runs on the card;
`--device cpu` on the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch
from torch import nn

from ..core.device import resolve_device
from ..data.loaders import ArrayLoader
from ..data.noise import add_eval_noise, make_train_noise_augment
from ..evalharness import MetricsCalculator, write_results_json
from ..models.alpha_policy import AlphaPolicy
from ..ops.norms import ensure_2ch, normalize_piecewise
from ..ops.resize import bilinear_downscale_half
from ..train.rl import RLTrainer
from ..utils import save_checkpoint
from .quality_run import PUBLISHED, PUBLISHED_RUNTIME, load_model, mean_std, physical_payload, render_data


class ConstPolicy(nn.Module):
    """Deterministic constant-gain "policy": mu = logit(gain) for every
    sample, the null hypothesis the REINFORCE policy must beat
    (`apply_action` multiplies by sigmoid(mu), RL_policy.py:20-24)."""

    def __init__(self, gain: float):
        super().__init__()
        self.logit = float(np.log(gain / (1.0 - gain)))

    def forward(self, x: torch.Tensor):
        mu = torch.full((x.shape[0], 1), self.logit, dtype=torch.float32, device=x.device)
        return mu, torch.ones_like(mu)


def physical_eval(model, eval_images, eval_masks, batch: int, passes: int, policy=None):
    """Physical metrics under the published protocol, with the notebook
    norm convention: the published RL baseline file came from
    SwinWNet_RL_fine_tune_updated.ipynb, whose normalize carries the
    /log1p(1) division (cell 20)."""
    agg = None
    calc = MetricsCalculator(model, None, verbose=False, policy=policy, norm_convention="notebook")
    for k in range(passes):
        noisy = add_eval_noise(eval_images[:, None].astype(np.float32), seed=k)[:, 0]
        calc.val_loader = ArrayLoader(noisy, eval_masks, batch_size=batch)
        m = calc.CalculatePhysycalMetrics()
        if agg is None:
            agg = m
        else:
            for key in agg:
                agg[key] = np.concatenate([agg[key], m[key]])
    return agg


def summary_of(values) -> dict:
    return {k: mean_std(v) for k, v in values.items()}


@torch.inference_mode()
def alpha_statistics(policy: AlphaPolicy, eval_images: np.ndarray) -> dict:
    """The learned policy's mu and gain sigmoid(mu) over the eval set's
    normalized x0.5 patterns (unmasked)."""
    device = next(policy.parameters()).device
    x2 = ensure_2ch(torch.as_tensor(eval_images[:, None].astype(np.float32)).to(device))
    norm_lr, _ = normalize_piecewise(bilinear_downscale_half(x2))
    mus = policy(norm_lr)[0].float().cpu().numpy().ravel()
    gains = 1.0 / (1.0 + np.exp(-mus))
    return {
        "mu_mean": float(mus.mean()), "mu_std": float(mus.std()),
        "gain_mean": float(gains.mean()), "gain_min": float(gains.min()),
        "gain_max": float(gains.max()),
    }


def state_copy(model: nn.Module) -> dict:
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--ckpt", default="QUALITY_r04_ckpt")
    p.add_argument("--out", default="QUALITY_r04_rl")
    p.add_argument("--height", type=int, default=250)
    p.add_argument("--width", type=int, default=480)
    p.add_argument("--train-crystals", type=int, default=32)
    p.add_argument("--renders-per-crystal", type=int, default=4)
    p.add_argument("--eval-renders-per-crystal", type=int, default=8)
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--epochs", type=int, default=20)
    p.add_argument("--noise-passes", type=int, default=5)
    p.add_argument("--lambda-rec", type=float, default=10.0)
    p.add_argument("--policy-lr", type=float, default=1e-4)
    p.add_argument("--model-lr", type=float, default=1e-5)
    p.add_argument("--compute-dtype", choices=("fp32", "bf16"), default="bf16",
                   help="RL step compute precision")
    p.add_argument("--ablation-gains", default="0.40,0.45,0.50,0.55,0.60",
                   help="constant-gain grid for the REINFORCE-vs-scalar ablation")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--fused-blocks", action="store_true",
                   help="route the levels the gate admits through the fused Swin-block kernel")
    return p.parse_args(argv)


def main(argv=None):
    """Returns the summary."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    t_start = time.time()

    _, train_images, _, eval_images, eval_masks = render_data(args, device)
    print(f"train {train_images.shape}, eval {eval_images.shape}")
    model, path, tree = load_model(args.ckpt, device, args.fused_blocks, **PUBLISHED_RUNTIME)
    print(f"loaded {path}")
    policy = AlphaPolicy(device=device, generator=torch.Generator().manual_seed(1))

    def evaluate(passes=args.noise_passes, policy=None):
        return physical_eval(model, eval_images, eval_masks, args.batch, passes, policy)

    print("pre-RL physical metrics...")
    pre_summary = summary_of(evaluate())
    print(json.dumps(pre_summary))

    # REINFORCE + supervised L1, two optimizers, on the quality run's
    # additive-noise augmentation; the model trains in place, so keep the
    # starting weights for the ablation
    pre_state = state_copy(model)
    train_loader = ArrayLoader(
        train_images, np.zeros_like(train_images, dtype=np.uint8),
        batch_size=args.batch, shuffle=True, augment=make_train_noise_augment(),
    )
    trainer = RLTrainer(
        model, policy, train_loader, num_epochs=args.epochs, lambda_rec=args.lambda_rec,
        policy_lr=args.policy_lr, model_lr=args.model_lr,
        compute_dtype="bfloat16" if args.compute_dtype == "bf16" else None,
    )
    t0 = time.time()
    history = trainer.fit()
    rl_minutes = (time.time() - t0) / 60
    print(f"RL fit done in {rl_minutes:.1f} min")
    post_state = state_copy(model)
    save_checkpoint(os.path.abspath(f"{args.out}_ckpt"), {
        "params": post_state, "policy": policy.state_dict(), "model": dict(tree.get("model", PUBLISHED))})

    print("post-RL physical metrics (deterministic mu action)...")
    post = evaluate(policy=policy)
    post_summary = summary_of(post)
    print(json.dumps(post_summary))

    # ablation: REINFORCE policy against a constant gain found by grid
    # search. (pre-RL model + best constant gain) isolates what a scalar
    # alone buys; (post-RL model + best constant gain) whether the learned
    # policy adds anything beyond a scalar on top of the supervised L1
    gains = [float(g) for g in args.ablation_gains.split(",")]
    ablation = {"grid": {}, "noise_passes_grid": 2}
    for tag, state in (("pre_model", pre_state), ("post_model", post_state)):
        model.load_state_dict(state)
        rows = {}
        for g in gains:
            m = evaluate(passes=2, policy=ConstPolicy(g))
            rows[f"{g:.2f}"] = {k: round(float(np.mean(v)), 4) for k, v in m.items()}
            print(f"ablation {tag} gain={g:.2f}: {rows[f'{g:.2f}']}")
        ablation["grid"][tag] = rows
    print("ablation done")

    write_results_json(f"{args.out}_physical_metrics.json", physical_payload(post))

    summary = {
        "run": args.out,
        "config": "SwinWNet + RL alpha policy (+error matrix) — BASELINE config #5",
        "start_checkpoint": path,
        "epochs": args.epochs,
        "rl_minutes": round(rl_minutes, 1),
        "n_eval_samples": int(len(eval_images) * args.noise_passes),
        "reward_curve": [h["reward"] for h in history],
        "final_epoch_metrics": history[-1] if history else {},
        "alpha": alpha_statistics(policy, eval_images),
        "physical_pre": pre_summary,
        "physical_post": post_summary,
        "ablation_constant_gain": ablation,
        "shape_trade_note": (
            "the reward weights (lambda 2/1/0.5, RL_finetuning_pipline.py:220-230) "
            "license trading the lowest-weighted term: the published RL run shows "
            "the same pattern in the other direction — its integral WORSENED "
            "1.980 -> 2.237 while peak improved 5.865 -> 1.950 "
            "(results/SwinWnet_diffraction+error_matrix_... vs "
            "..._simple_alpha_policy_...). A shape or integral regression after "
            "RL is therefore a parity observation, not a defect."
        ),
        "published_rl_baseline": {
            "file": "results/SwinWnet_simple_alpha_policy_diffraction+error_matrix_physycal_metrics.json",
            "integral": [2.237, 1.988], "peak": [1.950, 2.468], "shape": [0.0259, 0.0146],
            "note": (
                "published numbers use the real McStas dataset + released weights "
                "(unavailable here); the comparison that matters here is "
                "physical_pre vs physical_post — did REINFORCE move the metrics"
            ),
        },
    }
    with open(f"{args.out}.json", "w") as f:
        json.dump(summary, f, indent=1)
    print(f"wrote {args.out}.json (total {(time.time() - t_start) / 60:.1f} min)")
    return summary


if __name__ == "__main__":
    main()
