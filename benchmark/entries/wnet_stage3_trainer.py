"""Training entry: `swinwnet_tpu_torch.train.FullModelTrainer.train_step`,
stage 3 of SwinWNet (both towers, the cross-attentions, all parameters
train), alternating even and odd steps as its epoch loop does.

The comparison reads each step's loss, the optimizer's first moment after
one step (the first gradient: m / (1 - b1)) and the parameters after the
first steps.
"""

from __future__ import annotations

from typing import Dict

import torch

from ..yardstick import reference
from .wnet_inference import load


def first_grad_norms(names, params, moments, b1: float) -> Dict[str, float]:
    """Each leaf's first gradient norm, from its first moment after one
    step: m = (1 - b1) g."""
    norms = torch.stack([m.norm() for m in moments]).cpu() / (1.0 - b1)
    return {names[id(p)]: float(n) for p, n in zip(params, norms)}


def change_norms(model: torch.nn.Module, start: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """Each leaf's distance from its value in `start`."""
    params = dict(model.named_parameters())
    norms = torch.stack([(params[n].detach() - t).norm() for n, t in start.items()]).cpu()
    return dict(zip(start, norms.tolist()))


class _Epoch:
    """What the trainer asks of a loader before it steps: its length (the
    steps of an epoch, for the learning-rate schedule)."""

    def __init__(self, steps: int):
        self.steps = steps

    def __len__(self) -> int:
        return self.steps


class Program:
    def __init__(self, config: dict, traffic: dict, state_dict: Dict[str, torch.Tensor], device):
        from swinwnet_tpu_torch.models import SwinWNet
        from swinwnet_tpu_torch.train import FullModelTrainer

        model = SwinWNet(
            patch_size=config["patch_size"], in_chans=config["in_chans"], error_matrix=config["error_matrix"],
            embed_dim=config["embed_dim"], depths=config["depths"], num_heads=config["num_heads"],
            window_size=config["window_size"], mlp_ratio=config["mlp_ratio"], dtype="float32",
            fused_blocks=config["fused_blocks"], attn_chunk=config["attn_chunk"], remat=config["remat"],
            device=device)
        load(model, state_dict)
        self.names = {id(p): n for n, p in model.named_parameters()}
        self.model = model
        trainer = traffic["trainer"]
        self.trainer = FullModelTrainer(
            model, _Epoch(trainer["steps_per_epoch"]), lr=trainer["lr"], warmup_epochs=trainer["warmup_epochs"],
            num_epochs=trainer["num_epochs"], weight_decay=trainer["weight_decay"], compute_dtype=config["dtype"],
            verbose=False)

    def step(self, images, masks, even: bool) -> torch.Tensor:
        return self.trainer.train_step(images, masks, even=even)["loss"]

    def first_grad_norms(self) -> Dict[str, float]:
        opt = self.trainer.optimizer
        return first_grad_norms(self.names, opt.params, opt.m, opt.b1)

    def change_norms(self, start: Dict[str, torch.Tensor]) -> Dict[str, float]:
        return change_norms(self.model, start)


class Reference:
    """The reference's training: float32 (or, as the control, float8
    products) forward and backward of the stage-3 objective, and AdamW on
    the same schedule."""

    def __init__(self, config: dict, traffic: dict, state_dict: Dict[str, torch.Tensor], device, fp8: bool = False):
        self.model = reference.build(config, device, fp8=fp8)
        self.model.load_state_dict(state_dict)
        self.t = trainer = traffic["trainer"]
        self.opt = reference.RefAdamW(self.model.parameters(), trainer["weight_decay"])
        self.names = {id(p): n for n, p in self.model.named_parameters()}
        self.k = 0

    def step(self, images, masks, even: bool) -> torch.Tensor:
        t = self.t
        lr = reference.warmup_cosine(t["lr"], t["warmup_epochs"], t["num_epochs"], t["steps_per_epoch"], self.k)
        for p in self.model.parameters():
            p.grad = None
        loss = reference.stage3_loss(self.model, images, masks, even)
        loss.backward()
        self.opt.step(lr)
        self.k += 1
        return loss.detach()

    def first_grad_norms(self) -> Dict[str, float]:
        return first_grad_norms(self.names, self.opt.params, self.opt.m, self.opt.b1)

    def change_norms(self, start: Dict[str, torch.Tensor]) -> Dict[str, float]:
        return change_norms(self.model, start)


def Control(config: dict, traffic: dict, state_dict: Dict[str, torch.Tensor], device) -> Reference:
    """The reference with float8 products, in the program's place."""
    return Reference(config, traffic, state_dict, device, fp8=True)
