"""SwinWNet in PyTorch for an NVIDIA H100: a port of `swinwnet_tpu`.

The port imports torch and nothing of JAX or of the JAX package. It mirrors
that package's layout:

core       configuration dataclasses, device and dtype selection
ops        windowing, resize, normalization, and the fused Swin-block kernel
           (CUDA C++ in ops/csrc, built with nvcc on first use)
models     nn.Module SwinWNet with the upstream torch state-dict names
pipelines  the 8-stage inference pipeline
compat     upstream .pth loading and the JAX-params bridge

Entry points run on the CUDA device unless the caller passes device="cpu";
on the CPU the kernel's plain PyTorch version stands in for it.
"""

__version__ = "0.1.0"
