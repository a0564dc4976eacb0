"""SwinWNet in PyTorch for an NVIDIA H100: a port of `swinwnet_tpu`.

The port imports torch and nothing of JAX or of the JAX package. It mirrors
that package's layout:

core       configuration dataclasses, device and dtype selection
ops        windowing, resize, normalization, and the fused Swin-block kernels
           (CUDA C++ in ops/csrc, built with nvcc on first use) with their
           differentiable entry point
models     nn.Module SwinWNet with the upstream torch state-dict names, and
           the RL alpha policy
pipelines  the 8-stage inference pipeline, and its RL variant
physics    d-space rebinning, peak finding and the peak metrics on the
           device; the host scipy oracle of the published metric spec
train      losses, schedule, stage freezing with AdamW, the three
           supervised trainers and their pipeline, the REINFORCE fine-tune
utils      JSONL metrics logging, checkpoints on torch.save
compat     upstream .pth loading and the JAX-params bridge, both ways
apps       the viewer CLI, the labeler and their state models
parallel   data parallelism on torch.distributed and the multi-card dry run

Entry points run on the CUDA device unless the caller passes device="cpu";
on the CPU a kernel's plain PyTorch version stands in for it.
"""

__version__ = "0.1.0"
