"""Data parallelism on `torch.distributed` (port of `swinwnet_tpu/parallel`):
the process group, the 1-D data mesh, batch sharding, the gradient
all-reduce, and the multi-card dry run."""

from .dryrun import dryrun_multichip
from .multihost import initialize_multihost, process_batch_slice
from .sharding import (
    allreduce_gradients,
    data_parallel,
    data_sharding,
    make_mesh,
    pad_to_multiple,
    replicate,
    shard_batch,
)

__all__ = [
    "initialize_multihost",
    "make_mesh",
    "replicate",
    "shard_batch",
    "data_sharding",
    "pad_to_multiple",
    "process_batch_slice",
    "allreduce_gradients",
    "data_parallel",
    "dryrun_multichip",
]
