"""Serving entry: the 8-stage SwinWNet pipeline through
`swinwnet_tpu_torch.pipelines.SwinWNetInference.__call__`.

A request is a host array [B, 2, H, W] (counts and their Poisson error).
The answer fetched to the host is `images_masked_hr` [B, 2, 2H, 2W]; the
comparison also reads the call's `seg_map_lr`, `upscaled_denorm` and
`seg_map_hr`. Together they cover both towers, the fused and the plain
levels, the gated cross-attention, the SR head, normalize and denormalize.
"""

from __future__ import annotations

from typing import Dict

import torch

from ..yardstick import reference

OUTPUTS = ("seg_map_lr", "upscaled_denorm", "seg_map_hr", "images_masked_hr")
ANSWER = "images_masked_hr"


def request_shape(config: dict, batch: int):
    return (batch, config["in_chans"] + int(config["error_matrix"]), config["height"], config["width"])


class Program:
    """The system under test, built from the configuration and loaded with
    the benchmark's state dict."""

    def __init__(self, config: dict, traffic: dict, state_dict: Dict[str, torch.Tensor], device):
        from swinwnet_tpu_torch.models import SwinWNet
        from swinwnet_tpu_torch.pipelines import SwinWNetInference

        model = SwinWNet(
            patch_size=config["patch_size"], in_chans=config["in_chans"], error_matrix=config["error_matrix"],
            embed_dim=config["embed_dim"], depths=config["depths"], num_heads=config["num_heads"],
            window_size=config["window_size"], mlp_ratio=config["mlp_ratio"], dtype=config["dtype"],
            fused_blocks=config["fused_blocks"], attn_chunk=config["attn_chunk"], device=device)
        load(model, state_dict)
        self.inference = SwinWNetInference(model)

    def __call__(self, x) -> Dict[str, torch.Tensor]:
        self.inference(x)
        return {name: getattr(self.inference, name) for name in OUTPUTS}


class Control:
    """The reference with float8 products, in the program's place, a block
    of rows at a time."""

    def __init__(self, config: dict, traffic: dict, state_dict: Dict[str, torch.Tensor], device):
        self.model = reference.build(config, device, fp8=True)
        self.model.load_state_dict(state_dict)
        self.device, self.block = device, traffic["check_block"]

    @torch.no_grad()
    def __call__(self, x) -> Dict[str, torch.Tensor]:
        x = torch.as_tensor(x).to(self.device)
        parts = [self.model.serve(x[i:i + self.block]) for i in range(0, len(x), self.block)]
        return {name: torch.cat([p[name] for p in parts]) for name in parts[0]}


def load(model: torch.nn.Module, state_dict: Dict[str, torch.Tensor]) -> None:
    """The drawn state dict into the program: every parameter by name; the
    only keys it may lack are the buffers the model derives itself."""
    missing, unexpected = model.load_state_dict(state_dict, strict=False)
    derived = [k for k in missing if not k.endswith("relative_position_index")]
    if derived or unexpected:
        raise KeyError(f"state dict and program disagree: missing {derived[:5]}, unexpected {unexpected[:5]}")


@torch.no_grad()
def reference_outputs(model: torch.nn.Module, x: torch.Tensor) -> Dict[str, torch.Tensor]:
    return model.serve(x)
