"""Per-stage parameter freezing and the optimizer (port of
`swinwnet_tpu/train/freeze.py`).

The stage vocabularies name the top-level modules of SwinWNet that train:
  stage1  train: patch_embed + segmentator_*          freeze: upscaler_*, ca_*
  stage2  train: upscaler_*                           freeze: rest
  stage3  train: everything
  rl      train: upscaler_* + ca_seg_to_sr            freeze: rest
  all     train: everything
Freezing is `requires_grad`; the optimizer is AdamW over the trainable
parameters, with the arithmetic of `optax.adamw`.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Union

import torch
from torch import nn

_STAGE_TRAINABLE: Dict[str, Callable[[str], bool]] = {
    "stage1": lambda top: top == "patch_embed" or top.startswith("segmentator_"),
    "stage2": lambda top: top.startswith("upscaler_"),
    "stage3": lambda top: True,
    "rl": lambda top: top.startswith("upscaler_") or top == "ca_seg_to_sr",
    "all": lambda top: True,
}


def stage_trainable_names(model: nn.Module, stage: str) -> List[str]:
    """Names of the parameters `stage` trains."""
    pred = _STAGE_TRAINABLE[stage]
    return [name for name, _ in model.named_parameters() if pred(name.split(".")[0])]


def apply_stage_freeze(model: nn.Module, stage: str) -> List[nn.Parameter]:
    """Set `requires_grad` for `stage` on every parameter; returns the
    trainable ones."""
    names = set(stage_trainable_names(model, stage))
    for name, p in model.named_parameters():
        p.requires_grad_(name in names)
    return [p for p in model.parameters() if p.requires_grad]


class AdamW:
    """AdamW as `optax.adamw` computes it: m and v with bias correction,
    update = -lr * (m_hat / (sqrt(v_hat) + eps) + weight_decay * p), the
    decay decoupled and scaled by the learning rate. `learning_rate` is a
    float or a schedule, asked with the count of steps taken.

    `count` is an int64 tensor on the parameters' device, and a step reads
    the learning rate (the schedule evaluated on that tensor) and the fp32
    bias corrections there, with no host sync: a CUDA graph can capture a
    step, and each replay reads the count it has reached. A schedule is
    called with the count tensor and returns an fp32 tensor or a float
    (`warmup_cosine_schedule` does either).

    `grad_transform`, None by default, is a function a step applies in
    place to the gradients before the update, as optax chains a transform
    before its optimizer: `parallel.data_parallel` sets it to the mean over
    a data mesh. Set it before the first step a program captures."""

    def __init__(self, params, learning_rate: Union[float, Callable], weight_decay: float = 1e-4,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.params = list(params)
        self.learning_rate, self.weight_decay = learning_rate, weight_decay
        self.b1, self.b2, self.eps = b1, b2, eps
        device = self.params[0].device if self.params else torch.device("cpu")
        self.count = torch.zeros((), dtype=torch.int64, device=device)
        self.m = [torch.zeros_like(p) for p in self.params]
        self.v = [torch.zeros_like(p) for p in self.params]
        self.grad_transform: Optional[Callable[[List[torch.Tensor]], None]] = None

    def lr(self):
        """The learning rate of the next step: a tensor on the count's
        device for a schedule, the float for a constant."""
        lr = self.learning_rate
        return lr(self.count) if callable(lr) else float(lr)

    def tensors(self) -> List[torch.Tensor]:
        """What a step reads and writes in place besides the parameters and
        their gradients: the count and both moments."""
        return [self.count, *self.m, *self.v]

    @torch.no_grad()
    def step(self) -> None:
        """One update from the parameters' `.grad` (a missing grad counts as 0)."""
        lr = self.lr()
        self.count += 1
        ps, ms, vs = self.params, self.m, self.v
        if not ps:
            return
        if self.grad_transform is not None:
            self.grad_transform([p.grad for p in ps if p.grad is not None])
        # the bias corrections in fp32, as optax takes them: 1 - 0.999**t loses
        # five digits there, and the parity with the JAX trainers rests on it
        t = self.count.float()
        c1 = 1.0 - torch.pow(self.b1, t)
        c2 = 1.0 - torch.pow(self.b2, t)
        gs = [p.grad if p.grad is not None else torch.zeros_like(p) for p in ps]
        torch._foreach_mul_(ms, self.b1)
        torch._foreach_add_(ms, gs, alpha=1.0 - self.b1)
        torch._foreach_mul_(vs, self.b2)
        torch._foreach_addcmul_(vs, gs, gs, value=1.0 - self.b2)
        denom = torch._foreach_div(vs, c2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        upd = torch._foreach_div(ms, c1)
        torch._foreach_div_(upd, denom)
        torch._foreach_add_(upd, ps, alpha=self.weight_decay)
        if isinstance(lr, torch.Tensor):
            torch._foreach_mul_(upd, lr)
            torch._foreach_sub_(ps, upd)
        else:
            torch._foreach_add_(ps, upd, alpha=-lr)

    def zero_grad(self) -> None:
        """Zero the gradients in place (the next backward accumulates into
        them): the gradient tensors keep their memory, so a captured step
        writes the gradients its caller reads."""
        grads = [p.grad for p in self.params if p.grad is not None]
        if grads:
            torch._foreach_zero_(grads)

    def state_dict(self) -> dict:
        return {"count": int(self.count), "m": [m.clone() for m in self.m], "v": [v.clone() for v in self.v]}

    def load_state_dict(self, state: dict) -> None:
        """In place (a captured step keeps reading the same tensors); `count`
        may be an int, as every checkpoint holds it, or a tensor."""
        self.count.fill_(int(state["count"]))
        for dst, src in zip(self.m, state["m"]):
            dst.copy_(src)
        for dst, src in zip(self.v, state["v"]):
            dst.copy_(src)


def masked_adamw(model: nn.Module, stage: str, learning_rate, weight_decay: float = 1e-4,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8) -> AdamW:
    """Freeze `model` for `stage` and return AdamW over what trains; frozen
    parameters get no update at all."""
    return AdamW(apply_stage_freeze(model, stage), learning_rate, weight_decay, b1, b2, eps)
