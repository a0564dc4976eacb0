"""Multi-process initialization (port of `swinwnet_tpu/parallel/multihost.py`)
on `torch.distributed`.

One process drives one card. `initialize_multihost` brings up the process
group every rank joins (NCCL on the card, gloo on the CPU); the ranks then
build the 1-D data mesh (`sharding.make_mesh`) over it. Where JAX's GSPMD
inserts the gradient psum, a torch rank's optimizer takes the mean over
the mesh before its update (`sharding.data_parallel`).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from ..core.device import resolve_device


def initialize_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device: str = "cuda",
    backend: Optional[str] = None,
) -> bool:
    """`init_process_group` over `tcp://{coordinator_address}` ("host:port",
    the address of rank 0) with `num_processes` ranks, this one
    `process_id`.

    Returns False (nothing to do) for a single process with no coordinator,
    as the JAX function does, and True once the group is up. `backend`
    defaults to "nccl" on the card and "gloo" on the CPU; on the card the
    process takes card `process_id % device_count`, and a missing card or
    NCCL raises: the group turns to gloo there only when the caller names
    it."""
    if num_processes in (None, 1) and coordinator_address is None:
        return False
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError("a process group needs coordinator_address, num_processes and process_id")
    dev = resolve_device(device)
    if dev.type == "cuda":
        backend = backend or "nccl"
        if backend == "nccl" and not dist.is_nccl_available():
            raise RuntimeError("this PyTorch has no NCCL; pass backend='gloo' to use gloo on the card")
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    else:
        backend = backend or "gloo"
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)
    return True


def process_batch_slice(
    global_batch: int,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> slice:
    """This process's contiguous slice of a global batch: each rank loads and
    feeds its own slice. The global batch must divide evenly. The defaults
    are the group's size and this rank (1 and 0 with no group)."""
    up = dist.is_available() and dist.is_initialized()
    n = (dist.get_world_size() if up else 1) if num_processes is None else num_processes
    pid = (dist.get_rank() if up else 0) if process_id is None else process_id
    if global_batch % n != 0:
        raise ValueError(f"global batch {global_batch} not divisible by {n} processes")
    per = global_batch // n
    return slice(pid * per, (pid + 1) * per)
