"""The 1-D data mesh and data parallelism (port of
`swinwnet_tpu/parallel/sharding.py`) on `torch.distributed`.

Parameters are replicated and the batch axis is split over the ranks of
the group `multihost.initialize_multihost` brought up; each rank runs the
whole model on its slice. The model (~29M parameters) fits on one card,
so data parallelism is the strategy that pays, as in the JAX package.
JAX's GSPMD inserts the gradient all-reduce itself; here the optimizer
carries it: `data_parallel(tx, mesh)` makes an `AdamW` average its
gradients over the mesh before each update, as optax chains a transform
before its optimizer, so a step factory's program (`make_stage3_steps`
and the others) all-reduces inside the step, between the backward and the
update; a hand-written loop calls `allreduce_gradients` there instead. The
model is not wrapped in DistributedDataParallel: the trainers call
`segment_1` / `upscale` / `segment_2`, not the module's `forward` that DDP
hooks.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from .multihost import process_batch_slice


def make_mesh(n_devices: Optional[int] = None, axis_name: str = "data",
              device_type: Optional[str] = None):
    """1-D `DeviceMesh` named `axis_name` over the initialized group, one
    device a rank; `n_devices` (default: the group's size) must be that
    size. `device_type` defaults to "cuda" for an NCCL group and "cpu"
    otherwise (a gloo group on the card names "cuda")."""
    from torch.distributed.device_mesh import init_device_mesh

    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("no process group: call parallel.initialize_multihost first")
    world = dist.get_world_size()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"the mesh spans the group's {world} ranks, not {n_devices}")
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (world,), mesh_dim_names=(axis_name,))


def mesh_device(mesh) -> torch.device:
    """This rank's device in `mesh`."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def data_sharding(mesh):
    """The batch-axis placement over the 1-D mesh: [B, ...] split along dim
    0 (the DTensor placements of `distribute_tensor(x, mesh, ...)`)."""
    from torch.distributed.tensor import Shard

    return (Shard(0),)


@torch.no_grad()
def replicate(module: nn.Module, mesh) -> nn.Module:
    """Broadcast the parameters and buffers of the mesh's first rank to
    every rank, in place; returns `module`."""
    group = mesh.get_group()
    src = dist.get_global_rank(group, 0)
    for t in list(module.parameters()) + list(module.buffers()):
        dist.broadcast(t.data, src=src, group=group)
    return module


def shard_batch(batch, mesh):
    """This rank's contiguous slice of a global [B, ...] batch (numpy or a
    tensor; or a tuple or list of them), on the rank's device. B must be
    divisible by the mesh size (see `pad_to_multiple`)."""
    n, rank, dev = mesh.size(), mesh.get_local_rank(), mesh_device(mesh)

    def one(x):
        x = torch.as_tensor(x)
        return x[process_batch_slice(x.shape[0], n, rank)].to(dev)

    if isinstance(batch, (tuple, list)):
        return type(batch)(one(x) for x in batch)
    return one(batch)


@torch.no_grad()
def allreduce_gradients(module: nn.Module, mesh) -> None:
    """Average the `.grad` of every parameter that has one over the mesh,
    through one flat buffer. Every rank must hold the same set of
    gradients (frozen parameters have none on any rank)."""
    mean_over(mesh, [p.grad for p in module.parameters() if p.grad is not None])


def data_parallel(tx, mesh):
    """`tx` (an `AdamW`) with its gradients averaged over `mesh` before each
    update; returns `tx`. Every rank must hold the same set of gradients."""
    tx.grad_transform = functools.partial(mean_over, mesh)
    return tx


@torch.no_grad()
def mean_over(mesh, grads) -> None:
    """Average the tensors `grads` over the mesh in place, through one flat
    buffer (one all-reduce)."""
    if not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=mesh.get_group())
    flat /= mesh.size()
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()


def pad_to_multiple(array, multiple: int, axis: int = 0):
    """Pad the batch axis up to a multiple of the mesh size by repeating the
    last row. Returns (padded numpy array or `array` as it was, original
    size)."""
    n = array.shape[axis]
    rem = (-n) % multiple
    if rem == 0:
        return array, n
    pad_widths = [(0, 0)] * array.ndim
    pad_widths[axis] = (0, rem)
    return np.pad(np.asarray(array), pad_widths, mode="edge"), n
