"""Device selection for the port's entry points.

Entry points run on the card. The CPU is used only when the caller names it
(as the CPU tests do); with no card and no explicit request they raise
rather than quietly fall back.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """`None` means the current CUDA device; a CUDA device must exist."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "swinwnet_tpu_torch runs on a CUDA device and none is available; "
            "pass device='cpu' to run the plain PyTorch path on the CPU"
        )
    return dev


def resolve_dtype(dtype: Union[str, torch.dtype]) -> torch.dtype:
    """'float32' / 'bfloat16' (the JAX package's names) or a torch dtype."""
    if isinstance(dtype, torch.dtype):
        out = dtype
    else:
        out = {"float32": torch.float32, "bfloat16": torch.bfloat16}.get(str(dtype))
    if out not in (torch.float32, torch.bfloat16):
        raise ValueError(f"compute dtype must be float32 or bfloat16, got {dtype!r}")
    return out
