"""The multi-card dry run (port of `__graft_entry__.dryrun_multichip`): one
stage-3 odd training step of SwinWNet at the published width (embed 48,
depths 2-2-2-2, heads 3-6-12-24, window 5, error matrix), parameters
replicated and the batch split over the ranks of a `torch.distributed`
group, one process a rank.

The step is the odd step of `train.make_stage3_steps`, as the JAX dry
run takes it (`__graft_entry__.py:108`): each rank runs `segment_1` +
`upscale` + `segment_2` and both cross-attentions on its slice, its
backward, the gradients' mean over the mesh, then the stage-3 AdamW
update. The mean is the optimizer's (`sharding.data_parallel`, as optax
chains a transform before its optimizer), so it runs inside the step's
program: over NCCL the all-reduce is in the captured CUDA graph (the
communicator comes up in the warm-up, which runs eagerly). gloo on CUDA
tensors copies them through the host, which no graph can capture: a gloo
group on the card (`backend="gloo"`) runs its step under
`core.graphs.run_eagerly()`, and on the CPU a program is its function,
run eagerly. The loss terms are means over a slice, and the slices are
equal, so their average over the ranks is the batch's mean; the HR IoU
is the ratio of the summed intersections and unions.
"""

from __future__ import annotations

import contextlib
import math
import os
import socket
import tempfile
import time
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..core import graphs
from ..models.swin_wnet import SwinWNet
from ..train.freeze import masked_adamw
from ..train.losses import combined_loss, smooth_l1_loss
from ..train.trainers import TrainState, make_stage3_steps
from .multihost import initialize_multihost
from .sharding import data_parallel, make_mesh, mesh_device, replicate, shard_batch

PUBLISHED = dict(in_chans=1, error_matrix=True, embed_dim=48, depths=(2, 2, 2, 2), num_heads=(3, 6, 12, 24),
                 window_size=5)
LR = 1e-4
WEIGHTS = (1.0, 1.0, 1.0)  # seg_weight_lr, seg_weight_hr, rec_weight


def dryrun_batch(batch: int, hw: Tuple[int, int]):
    """The dry run's global batch, as the JAX dry run draws it: images
    uniform(0, 10) [B, 1, H, W] from numpy seed 0, masks > 0.5 of
    uniform [B, H, W] from seed 1."""
    H, W = hw
    images = np.random.default_rng(0).uniform(0, 10, (batch, 1, H, W)).astype(np.float32)
    masks = (np.random.default_rng(1).uniform(size=(batch, H, W)) > 0.5).astype(np.float32)
    return images, masks


def batch_terms(aux: dict, mesh) -> dict:
    """The batch's loss terms and HR IoU (floats) from each rank's step aux."""
    terms = torch.stack([aux[k].float() for k in ("loss", "seg_lr", "seg_hr", "hr_inter", "hr_union")])
    dist.all_reduce(terms, group=mesh.get_group())
    loss, seg_lr, seg_hr, inter, union = terms.tolist()
    n = mesh.size()
    return {"loss": loss / n, "seg_lr": seg_lr / n, "seg_hr": seg_hr / n, "iou_hr": inter / max(union, 1.0)}


def _rank_main(rank: int, n: int, port: int, device: str, backend: Optional[str], hw, per_device: int,
               model_kw: Optional[dict], seed: int, steps: int, out_path: str) -> None:
    if device == "cpu":  # the ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // n))
    initialize_multihost(f"localhost:{port}", n, rank, device=device, backend=backend)
    try:
        mesh = make_mesh(n, device_type="cuda" if device.startswith("cuda") else "cpu")
        dev = mesh_device(mesh)
        model = SwinWNet(**{**PUBLISHED, **(model_kw or {})}, device=dev,
                         generator=torch.Generator().manual_seed(seed))
        replicate(model, mesh)
        images, masks = shard_batch(dryrun_batch(n * per_device, hw), mesh)
        tx = data_parallel(masked_adamw(model, "stage3", LR), mesh)
        state = TrainState.create(model, tx)
        _, odd_step, _, _ = make_stage3_steps(model, tx, combined_loss, smooth_l1_loss, *WEIGHTS)
        gloo_on_card = dev.type == "cuda" and dist.get_backend(mesh.get_group()) == "gloo"
        steps_ms = []
        with graphs.run_eagerly() if gloo_on_card else contextlib.nullcontext():
            for _ in range(steps):
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
                t0 = time.perf_counter()
                state, aux = odd_step(state, images, masks)
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
                steps_ms.append((time.perf_counter() - t0) * 1e3)
        out = batch_terms(aux, mesh)
        out["step_ms"], out["steps_ms"] = steps_ms[-1], steps_ms
        if rank == 0:
            named = list(model.named_parameters())
            out["params"] = {k: p.detach().cpu() for k, p in named}
            out["grads"] = {k: p.grad.cpu() for k, p in named if p.grad is not None}
            torch.save(out, out_path)
    finally:
        dist.destroy_process_group()


def free_port() -> int:
    """A TCP port on localhost that is free now."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def dryrun_multichip(n_devices: int, device: str = "cuda", hw: Tuple[int, int] = (80, 120),
                     per_device: int = 1, backend: Optional[str] = None, model_kw: Optional[dict] = None,
                     seed: int = 0, steps: int = 1) -> dict:
    """One sharded stage-3 odd step over `n_devices` ranks (spawned
    processes, a group on a free localhost port), `per_device` samples of
    [1, H, W] = `hw` a rank, weights drawn from `seed` (`model_kw` overrides
    the published configuration). `device="cuda"` puts the ranks on the
    card (NCCL unless `backend` names another), "cpu" runs them over gloo.
    `steps` > 1 takes that many odd steps on the same batch: over NCCL the
    first is the program's warm-up and capture, each later one a replay.
    Returns rank 0's loss terms, HR IoU, the last step's time (`step_ms`,
    from the batch on the device to the update) and every step's
    (`steps_ms`), the last step's averaged gradients and the updated
    parameters (on the CPU); raises if a rank fails or the loss is not
    finite."""
    if device != "cpu" and not torch.cuda.is_available():
        raise RuntimeError("dryrun_multichip on the card needs a CUDA device; pass device='cpu' for gloo")
    with tempfile.TemporaryDirectory() as tmp:
        out_path = os.path.join(tmp, "rank0.pt")
        torch.multiprocessing.spawn(
            _rank_main, args=(n_devices, free_port(), device, backend, hw, per_device, model_kw, seed, steps, out_path),
            nprocs=n_devices, join=True)
        out = torch.load(out_path)
    if not math.isfinite(out["loss"]):
        raise FloatingPointError(f"the sharded step's loss is not finite: {out['loss']}")
    return out

