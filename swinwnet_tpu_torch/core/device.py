"""Device selection for the port's entry points, and its fp32 rule.

Entry points run on the card. The CPU is used only when the caller names it
(as the CPU tests do); with no card and no explicit request they raise
rather than quietly fall back. Their fp32 products run at full fp32 under
`full_fp32`, whatever TF32 flags the process has set.
"""

from __future__ import annotations

import contextlib
from typing import Iterator, Optional, Union

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


@contextlib.contextmanager
def full_fp32(dtype: torch.dtype = torch.float32) -> Iterator[None]:
    """Runs the fp32 products in the block at full fp32, as the JAX package's
    `Precision.HIGHEST` does, whatever the process-wide flags say: cuBLAS
    matmuls and cuDNN convolutions with TF32 off (PyTorch's default lets
    cuDNN round fp32 convolution operands to TF32's 10-bit mantissa, and
    `torch.set_float32_matmul_precision("high")` does the same to matmuls).
    The flags are put back on exit. With a bf16 `dtype` it changes nothing:
    the bf16 route's products keep the flags they find."""
    mm, dnn = torch.backends.cuda.matmul, torch.backends.cudnn
    if dtype != torch.float32 or not (mm.allow_tf32 or dnn.allow_tf32):
        yield
        return
    saved = mm.allow_tf32, dnn.allow_tf32
    mm.allow_tf32 = dnn.allow_tf32 = False
    try:
        yield
    finally:
        mm.allow_tf32, dnn.allow_tf32 = saved
